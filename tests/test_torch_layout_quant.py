"""Port parity, bit for bit: the strided pack/unpack layout and the min/max
quantizer of ``repro_torch.core`` against ``repro.core``; the port's config
copies against the JAX configs; and the port's import boundary."""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_configs
from repro.core import layout as jlayout
from repro.core import quantizer as jquant
from repro_torch import configs as tconfigs
from repro_torch.convert import to_torch
from repro_torch.core import layout as tlayout
from repro_torch.core import quantizer as tquant

REPO = Path(__file__).resolve().parent.parent


def bits_of(x) -> np.ndarray:
    """Raw bits of a torch or JAX array (bf16/f16 as int16) for bitwise
    comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind != "i" else a


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_bitwise(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 1 << bits, size=(3, 2, 64, 24), dtype=np.int32)
    q[..., -1] = (1 << bits) - 1  # codes in every plane, the top (sign) plane too
    jw = jlayout.pack_strided(jnp.asarray(q), bits)
    tw = tlayout.pack_strided(torch.from_numpy(q), bits)
    np.testing.assert_array_equal(bits_of(tw), bits_of(jw))
    assert (bits_of(tw) < 0).any()  # plane R-1 wrapped into the sign bit
    np.testing.assert_array_equal(tlayout.unpack_strided(tw, bits).numpy(), q)
    np.testing.assert_array_equal(
        tlayout.unpack_strided(tw, bits).numpy(),
        np.asarray(jlayout.unpack_strided(jw, bits)),
    )


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gran", ["channel", "tensor"])
def test_quantize_and_pack_bitwise(bits, gran):
    rng = np.random.default_rng(10 * bits + (gran == "tensor"))
    x = rng.standard_normal((2, 3, 64, 32)).astype(np.float32)
    x += 3.0 * rng.standard_normal(32).astype(np.float32)  # outlier channels
    x[0, 0, :, 0] = 0.25  # a constant channel: the scale floor _EPS
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    jw, js, jz = jquant.quantize_and_pack(xj, bits, gran, param_dtype=jnp.bfloat16)
    tw, ts, tz = tquant.quantize_and_pack(xt, bits, gran, param_dtype=torch.bfloat16)
    for t, j in ((tw, jw), (ts, js), (tz, jz)):
        assert t.dtype == to_torch(np.asarray(j)).dtype
        np.testing.assert_array_equal(bits_of(t), bits_of(j))
    np.testing.assert_array_equal(
        bits_of(tquant.unpack_and_dequantize(tw, ts, tz, bits, gran)),
        bits_of(jquant.unpack_and_dequantize(jw, js, jz, bits, gran)),
    )


def test_quant_params_float16_bitwise():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 128, 16)).astype(np.float32)
    js, jz = jquant.quant_params(jnp.asarray(x, jnp.bfloat16), 4, "channel",
                                 param_dtype=jnp.float16)
    ts, tz = tquant.quant_params(torch.from_numpy(x).to(torch.bfloat16), 4, "channel",
                                 param_dtype=torch.float16)
    np.testing.assert_array_equal(bits_of(ts), bits_of(js))
    np.testing.assert_array_equal(bits_of(tz), bits_of(jz))


@pytest.mark.parametrize("name", ["llama3-8b", "llama2-7b", "gemma-7b", "starcoder2-3b",
                                  "command-r-35b", "qwen3-moe-235b-a22b",
                                  "deepseek-v3-671b", "zamba2-7b", "xlstm-1.3b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_jax(name, smoke):
    get_t = tconfigs.smoke_config if smoke else tconfigs.get_config
    get_j = jax_configs.smoke_config if smoke else jax_configs.get_config
    tcfg, jcfg = get_t(name), get_j(name)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.g_q, tcfg.padded_vocab) == (jcfg.g_q, jcfg.padded_vocab)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    port = REPO / "src" / "repro_torch"
    for module in ("dist/__init__.py", "dist/splitkv.py", "dist/state_specs.py",
                   "launch/mesh.py",  # the distributed layer is held to it too
                   "train/__init__.py", "train/step.py", "train/tree.py",  # and training
                   "optim/__init__.py", "optim/adamw.py", "optim/adafactor.py",
                   "data/__init__.py", "data/pipeline.py", "checkpoint/__init__.py",
                   "checkpoint/manager.py", "launch/train.py"):
        assert port / module in files, module
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"
    # the pattern itself: catches the JAX package, spares the port
    assert _FORBIDDEN.search("from repro.core import layout")
    assert _FORBIDDEN.search("import repro\n")
    assert _FORBIDDEN.search("  import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.core import layout")
    assert not _FORBIDDEN.search("import repro_torch")
