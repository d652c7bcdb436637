"""The dense attention family and the MoE family in the port against the JAX
package, on the CPU.

gemma-7b (GeGLU, head_dim 256 at full width, ``(1 + w)`` RMSNorm, scaled
tied embeddings), starcoder2-3b (LayerNorm with bias, GELU MLP, MLP and QKV
biases), command-r-35b (parallel residual, LayerNorm, tied embeddings) and
qwen3-moe-235b-a22b (top-k MoE FFNs, q/k RMSNorm, GQA): their smoke
configs, JAX-initialized parameters carried over with ``params_from_jax``
and the port's init carried to JAX (qwen3's JAX model compiled as
written: ``jit_as_written``), prefill logits and
greedy decode steps across a residual flush within the repo's tolerance
(rtol 2e-2, atol 3e-1); the
serving engine's bucketed prefill against ``DecoderLM.prefill``; and the new
layers (LayerNorm, ``(1 + w)`` RMSNorm, GELU) bit for bit against JAX's.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jax_smoke
from repro.models import layers as jlayers
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models.params import leaves
from repro_torch.models.zoo import build_model
from repro_torch.serve import Request, ServeEngine

ARCHS = ["gemma-7b", "starcoder2-3b", "command-r-35b", "qwen3-moe-235b-a22b"]
MAX_SEQ, PROMPT, STEPS = 256, 48, 20
FLUSH = 64 - PROMPT - 1  # kv_block 64: the decode step (from 0) that flushes every row
TOL = dict(rtol=2e-2, atol=3e-1)
# JAX compiled as the program is written: without it XLA drops bf16 round
# trips (a bf16 result cast back to f32, as the q/k norm's output is by
# RoPE), and an MoE router then reads inputs a bf16 ulp off the program's,
# enough to flip a near-tie top-k choice (ROADMAP C); the dense archs keep
# jax.jit's default
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


def bits_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _pair(arch, seed=0):
    jm, tm = jax_build(jax_smoke(arch)), build_model(smoke_config(arch))
    jparams = jm.init(jax.random.PRNGKey(seed))
    return jm, tm, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), tm.cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Leaf for leaf: tied models have no ``unembed``, a parallel residual
    has no ``ln2``, LayerNorm brings ``b``, ``attn_bias`` brings the QKV
    and MLP biases, an MoE stack has ``moe`` (an f32 router and stacked
    expert weights) in place of ``mlp``, and ``qk_norm`` brings ``qnorm`` /
    ``knorm``."""
    _, tm, jparams, tparams = _pair(arch)
    paths = [path for path, _ in leaves(tm.param_defs())]
    jpaths = [tuple(getattr(k, "key", k) for k in kp)
              for kp, _ in jax.tree_util.tree_leaves_with_path(jparams)]
    assert sorted(paths) == sorted(jpaths)
    cfg = tm.cfg
    assert ("unembed" in tparams) != cfg.tie_embeddings
    assert ("ln2" in tparams["stack_0"]) != cfg.parallel_residual
    assert ("b" in tparams["final_norm"]) == (cfg.norm == "ln")
    assert {"bq", "bk", "bv"} <= set(tparams["stack_0"]["attn"]) if cfg.attn_bias else True
    blk = tparams["stack_0"]
    assert ("bi" in blk.get("mlp", {})) == cfg.attn_bias
    assert ("mlp" in blk) != bool(cfg.n_experts) and ("moe" in blk) == bool(cfg.n_experts)
    if cfg.n_experts:
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
        assert blk["moe"]["router"].dtype == torch.float32
        assert tuple(blk["moe"]["wi"].shape) == (cfg.n_layers, e, d, 2 * f)
        assert tuple(blk["moe"]["wo"].shape) == (cfg.n_layers, e, f, d)
    assert ({"qnorm", "knorm"} <= set(blk["attn"])) == cfg.qk_norm


def _to_jax(t: torch.Tensor):
    a = t.numpy() if t.dtype != torch.bfloat16 else (
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(a)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("init", ["jax", "port"])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_match_jax(arch, init, ragged):
    """Prefill logits and 20 decode steps, fed the JAX tokens; step FLUSH
    (15) flushes every row's residual and the steps from there on read the
    packed block.

    ``init="jax"``: JAX-initialized parameters through ``params_from_jax``,
    compared at prefill and at every step before the flush; after it,
    layer 0's packed block (its K/V depend on the tokens alone) is compared
    code for code.  At the JAX init's scales (3-D projections divided by the
    square root of the heads axis) the scores have a standard deviation in
    the tens, and a 4-bit code that flips on a last-bit K/V difference in
    layer 1 moves single logits past the tolerance (ROADMAP C; it does in
    starcoder2-3b here).  ``init="port"``: the port's own init carried to
    JAX leaf for leaf, O(1) scores, compared at every step, the flush and
    the steps after it included."""
    if init == "jax":
        jm, tm, jparams, tparams = _pair(arch)
        compared = range(FLUSH)
    else:
        jm, tm = jax_build(jax_smoke(arch)), build_model(smoke_config(arch))
        tparams = tm.init(torch.Generator().manual_seed(0), "cpu")
        jparams = jax.tree.map(_to_jax, tparams)
        compared = range(STEPS)
    rng = np.random.default_rng(1)
    b = 2 if ragged else 1
    tokens = rng.integers(0, tm.cfg.vocab, size=(b, PROMPT), dtype=np.int32)
    lengths = np.array([PROMPT, 37], np.int32) if ragged else None
    jkw = {} if lengths is None else {"lengths": jnp.asarray(lengths)}
    tkw = {} if lengths is None else {"lengths": torch.from_numpy(lengths)}

    jit = jit_as_written if tm.cfg.n_experts else jax.jit
    jl, jstate = jit(lambda p, t: jm.prefill(p, {"tokens": t}, MAX_SEQ, **jkw))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tstate = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, MAX_SEQ, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **TOL)

    step = jit(jm.decode_step)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        jl, jstate = step(jparams, jstate, tok)
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(np.array(tok)))
        if i in compared:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tc, jc = tstate["caches"][0], jstate["caches"][0]
    np.testing.assert_array_equal(tc.pack_blocks.numpy(), np.asarray(jc.pack_blocks))
    np.testing.assert_array_equal(tc.res_len.numpy(), np.asarray(jc.res_len))
    assert int(tc.pack_blocks[0, 0]) == 1
    agree = np.mean(tc.kw[0].numpy() == np.asarray(jc.kw[0]))
    assert agree > 0.95, agree


def test_engine_prefill_matches_model_prefill():
    """starcoder2-3b behind the serving engine: each request's first token
    and the logits of its bucketed prefill (ragged, right-padded to the
    bucket) against ``DecoderLM.prefill`` of that prompt alone."""
    _, tm, _, tparams = _pair("starcoder2-3b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tm.cfg.vocab, n).astype(np.int32) for n in (20, 45, 70)]
    engine = ServeEngine(tm, tparams, slots=3, max_seq=192, share_prefix=False, device="cpu")
    seen = {}
    prefill = engine._prefill

    def record(toks, lens):
        logits, state = prefill(toks, lens)
        for row, n in enumerate(lens.tolist()):
            seen[n] = logits[row, 0]
        return logits, state

    engine._prefill = record
    reqs = [Request(uid=i, prompt=p, max_new_tokens=2) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    with torch.no_grad():
        engine.run()
        for p, r in zip(prompts, reqs):
            ref, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(p)[None].long()}, 192)
            torch.testing.assert_close(seen[len(p)], ref[0, 0], **TOL)
            assert r.out_tokens[0] == int(ref[0, 0].argmax())


def _bf16_pair(x: np.ndarray):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm", "rmsnorm_plus_one"])
def test_norms_match_jax_bitwise(norm):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 33, 128)).astype(np.float32) * 3.0
    x += 2.0 * rng.standard_normal(128).astype(np.float32)  # a mean to take out
    w = (1.0 + 0.5 * rng.standard_normal(128)).astype(np.float32)
    b = (0.3 * rng.standard_normal(128)).astype(np.float32)
    xj, xt = _bf16_pair(x)
    pj = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    pt = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    if norm == "layernorm":
        out_j = jax.jit(jlayers.layernorm)(pj, xj)
        out_t = tlayers.layernorm(pt, xt)
    else:
        plus_one = norm == "rmsnorm_plus_one"
        out_j = jax.jit(lambda p, x: jlayers.rmsnorm(p, x, plus_one=plus_one))(pj, xj)
        out_t = tlayers.rmsnorm(pt, xt, plus_one=plus_one)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits_of(out_t), bits_of(out_j))


def test_gelu_matches_jax_bitwise():
    """Every normal bf16 value of magnitude in [2^-60, 2^10], and zero: the
    GELU of the MLPs as XLA evaluates a bf16 ``jax.nn.gelu``."""
    raw = np.arange(0, 1 << 15, dtype=np.int32).astype(np.uint16)
    vals = raw.view(np.int16)
    x = torch.from_numpy(np.concatenate([vals, vals | np.int16(-32768)])).view(torch.bfloat16)
    mag = x.float().abs()
    x = x[(mag == 0) | ((mag >= 2.0**-60) & (mag <= 2.0**10))]
    xj = jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))
    np.testing.assert_array_equal(bits_of(tlayers.gelu(x)), bits_of(jax.jit(jax.nn.gelu)(xj)))
