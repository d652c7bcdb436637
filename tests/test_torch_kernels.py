"""The port's three kernel modules against the JAX package's oracles.

Plain versions on the CPU: kv_quant and residual_flush bit for bit,
bitdecode within the reference's own tolerances (out 2e-2, lse 1e-3;
tests/test_kernels_bitdecode.py).  The CUDA kernels are held against these
plain versions on the card in tests/test_torch_gpu.py.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitdecode import ops as jbd_ops
from repro.kernels.kv_quant import ref as jkq_ref
from repro.kernels.residual_flush import ref as jrf_ref
from repro_torch.convert import to_torch
from repro_torch.kernels import _build
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.kv_quant import ops as kq_ops
from repro_torch.kernels.residual_flush import ops as rf_ops


def bits_of(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def from_jax(x) -> torch.Tensor:
    return to_torch(np.asarray(x))


def bf16_pair(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


# ------------------------------------------------------------------ kv_quant


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gran", ["channel", "tensor"])
@pytest.mark.parametrize("d", [32, 112, 160])  # 112: zamba2-7b's head; 160: the MLA smoke latent
def test_kv_quant_plain_matches_jax_bitwise(bits, gran, d):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 2, 3 * 64, d)).astype(np.float32)
    xj, xt = bf16_pair(x)
    ref = jkq_ref.quantize_kv_ref(xj, bits, gran, block_n=64)
    out = kq_ops.quantize_kv(xt, bits, gran, block_n=64)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(bits_of(o), bits_of(from_jax(r)))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
def test_kv_quant_pair_plain_writes_the_cache_like_two_jax_calls(bits, k_gran):
    """The pair's plain version, writing the first n_full blocks of a larger
    cache buffer through its views, equals two JAX quantize_kv_ref calls bit
    for bit; the blocks past n_full keep what they held."""
    rng = np.random.default_rng(200 + bits)
    b, h, d, block_n, n_full, nb = 2, 3, 64, 64, 2, 4
    k, v = (rng.standard_normal((b, h, n_full * block_n, d)).astype(np.float32) for _ in range(2))
    npr = block_n * bits // 32
    n_k = d if k_gran == "channel" else block_n
    cache = [torch.from_numpy(rng.integers(-2**31, 2**31, (b, h, nb, npr, d), dtype=np.int64)
                              .astype(np.int32)),
             torch.from_numpy(rng.standard_normal((b, h, nb, n_k))).to(torch.bfloat16),
             torch.from_numpy(rng.standard_normal((b, h, nb, n_k))).to(torch.bfloat16),
             torch.from_numpy(rng.integers(-2**31, 2**31, (b, h, nb, npr, d), dtype=np.int64)
                              .astype(np.int32)),
             torch.from_numpy(rng.standard_normal((b, h, nb, block_n))).to(torch.bfloat16),
             torch.from_numpy(rng.standard_normal((b, h, nb, block_n))).to(torch.bfloat16)]
    before = [c.clone() for c in cache]
    heads = [c[:, :, :n_full] for c in cache]
    (kj, kt), (vj, vt) = bf16_pair(k), bf16_pair(v)
    kq_ops.quantize_kv_pair(kt, vt, bits, k_gran, block_n=block_n, out_k=heads[:3],
                            out_v=heads[3:])
    want = [*jkq_ref.quantize_kv_ref(kj, bits, k_gran, block_n=block_n),
            *jkq_ref.quantize_kv_ref(vj, bits, "tensor", block_n=block_n)]
    for got, w, b0 in zip(cache, want, before):
        np.testing.assert_array_equal(bits_of(got[:, :, :n_full]), bits_of(from_jax(w)))
        np.testing.assert_array_equal(bits_of(got[:, :, n_full:]), bits_of(b0[:, :, n_full:]))


@pytest.mark.parametrize("change, match", [
    (dict(d=100), "head dims"), (dict(d=584), "head dims"),
    (dict(dtype=torch.float32), "bf16 inputs"), (dict(out_stride=2), "unit channel stride"),
    (dict(param_dtype=torch.float32), "bf16"), (dict(block_n=512), "block_n")])
def test_kv_quant_kernel_refuses_what_it_cannot_take(change, match):
    """The CUDA path's checks run before any build or launch: a head dim that
    is not a multiple of 8 or above 576, a non-bf16 input or params, out
    views with a channel stride other than 1, a block past 256 tokens."""
    d, block_n = change.get("d", 64), change.get("block_n", 64)
    x = torch.zeros((1, 2, 2 * block_n, d), dtype=change.get("dtype", torch.bfloat16))
    out = None
    if "out_stride" in change:
        wide = kq_ops.quantize_kv(torch.zeros((1, 2, 2 * block_n, 2 * d), dtype=torch.bfloat16),
                                  4, "channel", block_n=block_n, impl="torch")
        out = tuple(t[..., ::2] for t in wide)
    with pytest.raises(ValueError, match=match):
        kq_ops.quantize_kv_cuda(x, 4, "channel", block_n=block_n, out=out,
                                param_dtype=change.get("param_dtype", torch.bfloat16))


# ------------------------------------------------------------ residual_flush


def _flush_case(rng, *, b, h, nb, block_n, d, bits, k_gran):
    xk = rng.standard_normal((b, h, nb * block_n, d)).astype(np.float32)
    xv = rng.standard_normal((b, h, nb * block_n, d)).astype(np.float32)
    packed = [*jkq_ref.quantize_kv_ref(jnp.asarray(xk, jnp.bfloat16), bits, k_gran,
                                       block_n=block_n),
              *jkq_ref.quantize_kv_ref(jnp.asarray(xv, jnp.bfloat16), bits, "tensor",
                                       block_n=block_n)]
    res = [rng.standard_normal((b, h, block_n, d)).astype(np.float32) for _ in range(2)]
    full = np.array([1, 0, 1, 1][:b], np.int32)
    dest = np.array([0, 1, nb + 3, nb - 1][:b], np.int32)  # one past nb - 1
    return packed, res, full, dest


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
def test_residual_flush_plain_matches_jax_bitwise(bits, k_gran):
    rng = np.random.default_rng(100 + bits)
    packed, res, full, dest = _flush_case(rng, b=4, h=2, nb=3, block_n=64, d=32,
                                          bits=bits, k_gran=k_gran)
    jres = [jnp.asarray(r, jnp.bfloat16) for r in res]
    ref = jrf_ref.residual_flush_ref(
        *packed, *jres, jnp.asarray(full), jnp.asarray(dest), bits=bits,
        block_n=64, k_gran=k_gran, shared_kv=False,
    )
    tpacked = [from_jax(p) for p in packed]
    out = rf_ops.residual_flush(
        *tpacked, *(torch.from_numpy(r).to(torch.bfloat16) for r in res),
        torch.from_numpy(full), torch.from_numpy(dest), bits=bits, block_n=64,
        k_gran=k_gran,
    )
    for o, t, r in zip(out, tpacked, ref):
        assert o is t  # updated in place
        np.testing.assert_array_equal(bits_of(o), bits_of(from_jax(r)))


# ----------------------------------------------------------------- bitdecode


def _decode_case(seed, *, b, h, g, d, nb, block_n, bits, k_gran, pack_blocks, res_len):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, h, nb * block_n, d)).astype(np.float32)
    k += 3.0 * rng.standard_normal(d).astype(np.float32)  # outlier channels
    # per-channel V offsets keep the output O(1), so the 2e-2 tolerance is
    # small beside it and a fault on the PV side shows
    v_off = 2.0 * rng.standard_normal(d).astype(np.float32)
    v = rng.standard_normal((b, h, nb * block_n, d)).astype(np.float32) + v_off
    q = (rng.standard_normal((b, h, g, d)) / d**0.25).astype(np.float32)
    k_res = rng.standard_normal((b, h, block_n, d)).astype(np.float32)
    v_res = rng.standard_normal((b, h, block_n, d)).astype(np.float32) + v_off
    kw, ks, kz = jkq_ref.quantize_kv_ref(jnp.asarray(k, jnp.bfloat16), bits, k_gran,
                                         block_n=block_n)
    vw, vs, vz = jkq_ref.quantize_kv_ref(jnp.asarray(v, jnp.bfloat16), bits, "tensor",
                                         block_n=block_n)
    jcase = dict(
        q=jnp.asarray(q, jnp.bfloat16), kw=kw, k_scale=ks, k_zero=kz, vw=vw,
        v_scale=vs, v_zero=vz, k_res=jnp.asarray(k_res, jnp.bfloat16),
        v_res=jnp.asarray(v_res, jnp.bfloat16),
        pack_blocks=jnp.asarray(pack_blocks, jnp.int32),
        res_len=jnp.asarray(res_len, jnp.int32),
    )
    return jcase, {name: from_jax(a) for name, a in jcase.items()}


DECODE_CASES = [  # (g, d, block_n, bits, k_gran, pack_blocks, res_len)
    (1, 32, 64, 4, "channel", [4, 1], [37, 0]),
    (2, 32, 64, 2, "tensor", [0, 4], [5, 64]),
    (4, 128, 128, 4, "channel", [4, 3], [0, 100]),
    (4, 128, 128, 8, "tensor", [2, 4], [1, 127]),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("num_splits", [1, 2, 3])
def test_bitdecode_plain_matches_jax(case, num_splits):
    g, d, block_n, bits, k_gran, pb, rl = case
    jcase, tcase = _decode_case(num_splits, b=2, h=2, g=g, d=d, nb=4, block_n=block_n,
                                bits=bits, k_gran=k_gran, pack_blocks=pb, res_len=rl)
    kw = dict(bits=bits, block_n=block_n, k_gran=k_gran, num_splits=num_splits,
              return_lse=True)
    out_j, lse_j = jbd_ops.bitdecode_attention(**jcase, impl="xla", **kw)
    out_t, lse_t = bd_ops.bitdecode_attention(**tcase, impl="torch", **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-3, atol=1e-3)


def test_auto_splits_resolve_to_one_on_cpu():
    assert bd_ops.resolve_num_splits("auto", 1, 8, 256, "cpu") == 1
    assert bd_ops.resolve_num_splits(3, 1, 8, 256, "cpu") == 3
    with pytest.raises(ValueError, match="num_splits"):
        bd_ops.resolve_num_splits(0, 1, 8, 256, "cpu")
    # a full row of units gets UNITS_PER_WARP units a warp, within WAVES
    # waves of the card's resident CTAs (here 528: 132 SMs, four each)
    assert (bd_ops.WARPS, bd_ops.UNITS_PER_WARP, bd_ops.WAVES) == (4, 2, 2)
    units_32k = bd_ops.work_units(256, 128, 4, 128)  # B=1, H_kv=8 at 32K context
    assert units_32k == 256 * 4 + 16
    assert bd_ops.auto_num_splits(1, 8, units_32k, ctas=528) == 64  # the cap
    # the dense loop's shape: 18 blocks of 4 units and 16 residual units
    units_dense = bd_ops.work_units(18, 128, 4, 128)
    assert bd_ops.auto_num_splits(4, 8, units_dense, ctas=528) == 11
    # large batch: two waves of CTAs at most
    assert bd_ops.auto_num_splits(64, 8, units_32k, ctas=528) == 2
    assert bd_ops.auto_num_splits(128, 8, units_32k, ctas=528) == 1
    assert bd_ops.auto_num_splits(1, 1, 9, ctas=528) == 2


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("block_n", [32, 64, 128])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_decode_kernel_units_cover_every_block(bits, block_n, d):
    """A packed unit is 2 or 4 word rows of one block: every block splits
    into whole units of whole 16-token tiles, and the residual into units of
    8 tokens."""
    npr = block_n * bits // 32
    rows = bd_ops.unit_rows(block_n, bits)
    assert rows in (2, 4) and npr % rows == 0 and rows * (32 // bits) % 16 == 0
    assert rows == min(npr, 4)
    assert bd_ops.work_units(3, block_n, bits, block_n) == 3 * npr // rows + block_n // 8
    bd_ops.check_kernel_shapes(g=12, d_k=d, d_v=d, block_n=block_n, bits=bits, npr=npr,
                               res_n=block_n)


@pytest.mark.parametrize("d_k, d_v, g", [(576, 512, 128), (576, 512, 17), (160, 128, 4)])
def test_decode_kernel_shape_check_takes_latent_query_rows(d_k, d_v, g):
    """The shared_kv mode takes up to 128 query rows per KV head (16-row
    query tiles on the grid); the split K/V mode keeps one tile of 16."""
    bd_ops.check_kernel_shapes(g=g, d_k=d_k, d_v=d_v, block_n=128, bits=4, npr=16,
                               res_n=128, shared_kv=True)


@pytest.mark.parametrize("change, match", [
    (dict(g=17), "query rows"), (dict(g=0), "query rows"), (dict(d_k=96, d_v=96), "d_k = d_v"),
    (dict(d_v=64), "d_k = d_v"), (dict(bits=3, npr=12), "bits 2, 4 or 8"),
    (dict(block_n=256, npr=32), "block_n"), (dict(block_n=16, npr=2), "block_n"), (dict(npr=8), "packed word rows"),
    (dict(res_n=68), "multiple of 8"),
    (dict(g=129, d_k=576, d_v=512, shared_kv=True), r"query rows per KV head \(shared_kv\)")])
def test_decode_kernel_shape_check_raises(change, match):
    shape = dict(g=4, d_k=128, d_v=128, block_n=128, bits=4, npr=16, res_n=128) | change
    with pytest.raises(ValueError, match=match):
        bd_ops.check_kernel_shapes(**shape)


# --------------------------------------------------------- no silent fallback


def test_cuda_impl_on_cpu_tensors_raises():
    x = torch.zeros((1, 1, 64, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kq_ops.quantize_kv(x, 4, "channel", block_n=64, impl="cuda")
    _, tcase = _decode_case(0, b=1, h=1, g=2, d=32, nb=2, block_n=64, bits=4,
                            k_gran="channel", pack_blocks=[2], res_len=[3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        bd_ops.bitdecode_attention(**tcase, bits=4, block_n=64, impl="cuda")
    packed = [tcase[n] for n in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero")]
    with pytest.raises(ValueError, match="CUDA tensors"):
        rf_ops.residual_flush(*packed, tcase["k_res"], tcase["v_res"],
                              torch.ones(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), bits=4,
                              block_n=64, k_gran="channel", impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        kq_ops.quantize_kv(x, 4, "channel", block_n=64, impl="pallas")


def test_auto_takes_the_kernel_when_any_tensor_is_on_the_card():
    """'auto' resolves to the kernel as soon as one tensor lies on the card,
    and tensors split between the CPU and the card raise: no call reaches
    the plain version on the card unless it asks for impl='torch'."""
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    on_cpu = torch.zeros(1)
    assert _build.resolve_impl("auto", on_card, None, on_card) == "cuda"
    assert _build.resolve_impl("auto", on_cpu, None) == "torch"
    assert _build.resolve_impl("torch", on_card) == "torch"
    for impl in ("auto", "cuda"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            _build.resolve_impl(impl, on_card, on_cpu)
