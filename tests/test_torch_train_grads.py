"""The training loss and its gradients in the port against the JAX package,
on the CPU, for every model family at its smoke config.

Each family's ``loss`` through ``train.step.value_and_grad`` (autograd on
the parameter leaves) against ``jax.value_and_grad`` of JAX's ``loss``,
compiled once as written (``xla_allow_excess_precision: False``; ROADMAP C)
at the smoke config's own ``remat="none"``, on the port's init carried to
JAX and one batch of the port's data pipeline (B 2, S 32): the loss within
2e-3 relative, every gradient leaf within 3e-2 relative L2.  The port runs
with remat off and on (every block under ``torch.utils.checkpoint``, and for
xLSTM each 8-step time chunk) against that one compile, and the two runs
agree bit for bit.

Measured on the CPU (loss relative, the worst leaf's relative L2):
llama3-8b 5.0e-5 / 9.8e-3, qwen3-moe 4.0e-5 / 9.8e-3, deepseek-v3 6.1e-5 /
1.05e-2, zamba2-7b 2.7e-5 / 1.65e-2, xlstm-1.3b 5.7e-5 / 1.82e-2,
seamless-m4t 7.1e-5 / 1.51e-2, qwen2-vl 1.5e-5 / 1.85e-2.  The worst
leaves are small ones (norm weights, attention biases, whose gradients are
near zero), in bf16.

Also: every training forward reaches ``blockwise_attention`` with
``impl="torch"`` only (JAX's XLA attention), never the kernel route.
"""
import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs.base import smoke_config as jax_smoke
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.core import attention as tcatt
from repro_torch.data import pipeline as tpipe
from repro_torch.models.zoo import build_model
from repro_torch.train import tree as tr
from repro_torch.train.step import value_and_grad

FAMILIES = ["llama3-8b", "qwen3-moe-235b-a22b", "deepseek-v3-671b", "zamba2-7b",
            "xlstm-1.3b", "seamless-m4t-medium", "qwen2-vl-7b"]
LOSS_RTOL = 2e-3
GRAD_REL_L2 = 3e-2
SHAPE = ShapeSpec("test", 32, 2, "train")
jit_as_written = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size products run as fast on one thread; several test workers
    on a shared machine would oversubscribe it.  Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(t: torch.Tensor):
    a = t.numpy() if t.dtype != torch.bfloat16 else (
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(a)


def _setup(arch):
    cfg = smoke_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = tpipe.make_batch(cfg, SHAPE, step=3, device="cpu")
    return cfg, params, batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    cfg, params, batch = _setup(arch)
    assert cfg.remat == "none"
    jparams = tr.map_leaves(_to_jax, params)
    jbatch = {k: _to_jax(v) for k, v in batch.items()}
    jloss, jgrads = jit_as_written(jax.value_and_grad(jax_build(jax_smoke(arch)).loss))(
        jparams, jbatch)
    jloss = float(jloss)
    runs = {}
    for remat in ("none", "full"):
        model = build_model(cfg.with_(remat=remat, xlstm_time_chunk=64 if remat == "none" else 8))
        loss, grads = value_and_grad(model.loss, params, batch)
        assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss), (remat, float(loss), jloss)
        for (path, p), g in zip(tr.leaves_with_paths(params), grads):
            assert g.dtype == p.dtype and g.shape == p.shape, path
            want = np.asarray(tr.get(jgrads, path)).astype(np.float32)
            err = np.linalg.norm(g.float().numpy() - want) / max(np.linalg.norm(want), 1e-30)
            assert err <= GRAD_REL_L2, (remat, path, err)
        runs[remat] = (loss, grads)
    (l0, g0), (l1, g1) = runs["none"], runs["full"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1)), "remat changed a gradient"


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_attention_is_the_plain_loop(arch, monkeypatch):
    """The loss of every family calls ``blockwise_attention`` with
    ``impl="torch"``, explicitly (on the CPU ``"auto"`` would resolve to the
    same loop, so the argument itself is checked)."""
    seen = []
    real = tcatt.blockwise_attention

    def spy(*args, impl="auto", **kw):
        seen.append(impl)
        return real(*args, impl=impl, **kw)

    monkeypatch.setattr(tcatt, "blockwise_attention", spy)
    cfg, params, batch = _setup(arch)
    loss, _ = value_and_grad(build_model(cfg).loss, params, batch)
    assert torch.isfinite(loss)
    if cfg.mixer == "xlstm":
        assert seen == []
    else:
        assert seen and set(seen) == {"torch"}, seen
