"""Self-speculative decoding in the port, on the CPU, at the smoke size, on
the plain versions of the kernels: the counterpart of
``tests/test_serve_spec.py``.

* **The draft read** (``draft_bits``) of the plain decode attention, dense
  and paged, against the JAX package's XLA version on the same inputs made
  with numpy from a seed: out within rtol/atol 2e-2, lse within 1e-3, at
  bits 4 -> 1, 2, 3; 8 -> 2, 4; 2 -> 1 and both K granularities; with a
  widened residual (the port's width rounded up to the decode kernel's
  8-token unit against JAX's exact ``spec_k - 1``) whose rows run past
  ``block_n``.  ``draft_bits = bits`` is the normal read bit for bit.
* **The draft residual**: ``widen_residual`` and ``draft_append`` bit for bit
  against JAX's; the rounded-up width changes nothing.
* **One verify pass** against JAX's ``make_verify_fn`` on the same state (a
  port engine's, carried to JAX with the port's init, ROADMAP §C): ``v``,
  ``applied`` and ``finite`` equal; lengths and ``pos`` bit for bit; the
  residuals within rtol/atol 2e-2; the packed words equal but where the two
  frameworks' K/V differ by a bf16 ulp (at most 1% of the words); frozen and
  idle rows bit for bit unchanged.
* **The spec engine against itself at ``spec_k = 1``**: token streams and
  terminal phases bit for bit at ``spec_k`` 2 and 4, 4-bit channel and 2-bit
  tensor caches, under an oversubscribed pool with seeded faults
  (preemption and replay), a poisoned row, prefix sharing; the counters
  conserved; ``async_runtime=True`` equal to the sync cycle.
* **Against the JAX spec engine** on the carried parameters: streams equal
  up to each request's first decode step that reads a block packed by a
  flush, where they may part only at a near tie (JAX's token within the
  logits tolerance, rtol 2e-2 / atol 3e-1, of the port's best).
* **The rest of the engine's options** (``strict``, ``guard_logits``,
  ``metrics_every``/``metrics_sink``, ``detokenizer``) and the launcher's
  ``--spec-k``/``--spec-bits``, ``--strict`` and ``--metrics-every``.

On the CPU the draft and verify passes run eagerly; their CUDA graphs and
the draft read in the kernels are held to these on the card in
``tests/test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
from repro.configs.base import smoke_config as jax_smoke
from repro.core import qcache as jq
from repro.kernels.bitdecode import ops as jbd_ops
from repro.kernels.kv_quant import ref as jkq_ref
from repro.kernels.paged_bitdecode import ops as jpg_ops
from repro.models.zoo import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import speculative as jspec
from repro_torch.configs import smoke_config
from repro_torch.convert import to_torch
from repro_torch.core import qcache as tq
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.paged_bitdecode import ops as pg_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models.zoo import build_model
from repro_torch.serve import FaultPlan, Phase, Request, ServeEngine, audit_engine
from repro_torch.serve.speculative import VerifyPass

BLOCK = 32
OUT_TOL = dict(rtol=2e-2, atol=2e-2)
LSE_TOL = dict(rtol=1e-3, atol=1e-3)
TOL = dict(rtol=2e-2, atol=3e-1)  # the port's logits against JAX's (test_torch_serve.py)
DRAFT_PAIRS = [(4, 1), (4, 2), (4, 3), (8, 2), (8, 4), (2, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size products run as fast on one thread; with several test
    workers on a shared machine, PyTorch's default of a thread a core
    oversubscribes it many times over.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits_of(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def from_jax(x) -> torch.Tensor:
    return to_torch(np.asarray(x))


def to_jax(t: torch.Tensor):
    """A JAX array of a copy of ``t``: ``jnp.asarray`` of a numpy view can
    alias the tensor on the CPU, and JAX dispatches asynchronously, so a
    port pass writing the tensor in place afterwards could change what the
    pending JAX computation reads."""
    a = t.numpy() if t.dtype != torch.bfloat16 else (
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(np.array(a))


def bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


# --------------------------------------------------------------------------
# the draft read of the decode attention
# --------------------------------------------------------------------------


def _decode_case(seed, *, bits, k_gran, b=2, h=2, g=4, d=32, block_n=64, nb=3,
                 pack_blocks=(3, 2), res_len=(17, 64), res_extra=0):
    """Dense inputs as JAX arrays: a packed cache quantized from random K/V
    (V with per-channel offsets, so the output is O(1) beside the 2e-2
    tolerance) and a residual of ``block_n + res_extra`` tokens."""
    rng = np.random.default_rng(seed)
    v_off = 2.0 * rng.standard_normal(d).astype(np.float32)
    k = rng.standard_normal((b, h, nb * block_n, d)).astype(np.float32)
    v = rng.standard_normal((b, h, nb * block_n, d)).astype(np.float32) + v_off
    kq = jkq_ref.quantize_kv_ref(bf16(k), bits, k_gran, block_n=block_n)
    vq = jkq_ref.quantize_kv_ref(bf16(v), bits, "tensor", block_n=block_n)
    n_res = block_n + res_extra
    q = rng.standard_normal((b, h, g, d)).astype(np.float32)
    k_res = rng.standard_normal((b, h, n_res, d)).astype(np.float32)
    v_res = rng.standard_normal((b, h, n_res, d)).astype(np.float32) + v_off
    return dict(q=bf16(q), kw=kq[0], k_scale=kq[1], k_zero=kq[2], vw=vq[0], v_scale=vq[1],
                v_zero=vq[2], k_res=bf16(k_res), v_res=bf16(v_res),
                pack_blocks=jnp.asarray(pack_blocks, jnp.int32),
                res_len=jnp.asarray(res_len, jnp.int32))


def _assert_close(got, want):
    (out_t, lse_t), (out_j, lse_j) = got, want
    assert float(out_t.abs().max()) > 0.5  # the tolerance is small beside the output
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **OUT_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **LSE_TOL)


@pytest.mark.parametrize("bits, draft_bits", DRAFT_PAIRS)
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
def test_draft_read_plain_matches_jax(bits, draft_bits, k_gran):
    case = _decode_case(bits * 10 + draft_bits, bits=bits, k_gran=k_gran)
    kw = dict(bits=bits, block_n=64, k_gran=k_gran, return_lse=True, draft_bits=draft_bits)
    want = jbd_ops.bitdecode_attention(**case, impl="xla", **kw)
    got = bd_ops.bitdecode_attention(**{k: from_jax(v) for k, v in case.items()},
                                     impl="auto", **kw)
    _assert_close(got, want)
    # the truncated read differs from the normal one where blocks are packed
    full = bd_ops.bitdecode_attention(**{k: from_jax(v) for k, v in case.items()},
                                      impl="auto", **{**kw, "draft_bits": None})
    assert not torch.equal(got[0], full[0])


@pytest.mark.parametrize("bits, draft_bits", DRAFT_PAIRS)
def test_paged_draft_read_plain_matches_jax(bits, draft_bits):
    """Through a scrambled page table over a pool."""
    case = _decode_case(100 + bits * 10 + draft_bits, bits=bits, k_gran="channel")
    rng = np.random.default_rng(bits)
    b, nb = 2, 3
    order = rng.permutation(8)[:b * nb]
    table = order.reshape(b, nb).astype(np.int32)
    pools = []
    for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero"):
        x = np.asarray(case[f])  # [B, H, nb, ...] -> pool [8, H, ...], page = table entry
        pool = np.zeros((8, *x.shape[1:2], *x.shape[3:]), x.dtype)
        pool[order] = np.moveaxis(x, 2, 1).reshape(b * nb, *x.shape[1:2], *x.shape[3:])
        pools.append(jnp.asarray(pool))
    jargs = [case["q"], *pools, case["k_res"], case["v_res"], jnp.asarray(table),
             case["pack_blocks"], case["res_len"]]
    kw = dict(bits=bits, block_n=64, k_gran="channel", return_lse=True,
              draft_bits=draft_bits)
    want = jpg_ops.paged_bitdecode_attention(*jargs, impl="xla", **kw)
    got = pg_ops.paged_bitdecode_attention(*[from_jax(a) for a in jargs], impl="auto", **kw)
    _assert_close(got, want)


@pytest.mark.parametrize("spec_k", [2, 4, 11])
@pytest.mark.parametrize("paged", [False, True])
def test_draft_read_widened_residual_matches_jax(spec_k, paged):
    """The draft pass's residual: JAX widens it by exactly ``spec_k - 1``
    rows, the port to the next multiple of the kernel's 8-token unit; with
    rows whose ``res_len`` runs past ``block_n`` the reads agree, and the
    port's extra rows (zeros, past ``res_len``) change nothing."""
    extra = spec_k - 1
    width = -(-(64 + extra) // 8) * 8
    case = _decode_case(spec_k, bits=4, k_gran="channel", res_extra=width - 64,
                        res_len=(64 + extra, 64 + extra // 2))
    jcase = dict(case, k_res=case["k_res"][:, :, :64 + extra],
                 v_res=case["v_res"][:, :, :64 + extra])
    tcase = {k: from_jax(v) for k, v in case.items()}
    for f in ("k_res", "v_res"):
        tcase[f][:, :, 64 + extra:] = 0  # what widen_residual pads with
    kw = dict(bits=4, block_n=64, k_gran="channel", return_lse=True, draft_bits=2)
    if paged:
        ident = jnp.arange(6, dtype=jnp.int32).reshape(2, 3)
        pools = [jnp.moveaxis(case[f], 2, 1).reshape(6, *case[f].shape[1:2],
                                                     *case[f].shape[3:])
                 for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero")]
        want = jpg_ops.paged_bitdecode_attention(
            jcase["q"], *pools, jcase["k_res"], jcase["v_res"], ident, jcase["pack_blocks"],
            jcase["res_len"], impl="xla", **kw)
        got = pg_ops.paged_bitdecode_attention(
            tcase["q"], *[from_jax(p) for p in pools], tcase["k_res"], tcase["v_res"],
            from_jax(ident), tcase["pack_blocks"], tcase["res_len"], impl="auto", **kw)
    else:
        want = jbd_ops.bitdecode_attention(**jcase, impl="xla", **kw)
        got = bd_ops.bitdecode_attention(**tcase, impl="auto", **kw)
    _assert_close(got, want)
    # the port's width against the port at JAX's exact width: the extra rows
    # are masked, the two differ only in the plain version's f32 summation
    # order over the wider token axis (within 1e-5; the kernel reads no row
    # past res_len, bit for bit on the card)
    exact = {k: (v[:, :, :64 + extra] if k in ("k_res", "v_res") else v)
             for k, v in tcase.items()}
    if not paged:
        same = bd_ops.bitdecode_attention(**exact, impl="auto", **kw)
        for a, b in zip(same, got):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_draft_bits_at_full_width_is_the_normal_read(bits):
    """``draft_bits >= bits`` reads full fidelity: bit for bit the normal
    read, as in JAX; a draft read of a residual-only row is the normal read
    too (the truncation touches only the packed blocks)."""
    case = {k: from_jax(v) for k, v in _decode_case(bits, bits=bits, k_gran="channel").items()}
    kw = dict(bits=bits, block_n=64, k_gran="channel", return_lse=True)
    full = bd_ops.bitdecode_attention(**case, **kw)
    for db in (bits, 8):
        got = bd_ops.bitdecode_attention(**case, draft_bits=db, **kw)
        assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    res_only = dict(case, pack_blocks=torch.zeros(2, dtype=torch.int32))
    a = bd_ops.bitdecode_attention(**res_only, **kw)
    b = bd_ops.bitdecode_attention(**res_only, draft_bits=1, **kw)
    assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="draft_bits"):
        bd_ops.draft_shift(bits, 0)


# --------------------------------------------------------------------------
# the draft residual: widen_residual, draft_append
# --------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_widen_residual_and_draft_append_match_jax_bitwise(paged):
    b, h, d, block_n, extra = 3, 2, 32, 16, 5
    rng = np.random.default_rng(17 + paged)
    if paged:
        jc = jq.init_paged_cache(10, b, h, d, 4, bits=4, block_n=block_n, k_gran="channel")
        tc = tq.init_paged_cache(10, b, h, d, 4, bits=4, block_n=block_n, k_gran="channel",
                                 device="cpu")
    else:
        jc = jq.init_cache(b, h, d, 4 * block_n, bits=4, block_n=block_n, k_gran="channel")
        tc = tq.init_cache(b, h, d, 4 * block_n, bits=4, block_n=block_n, k_gran="channel",
                           device="cpu")
    k_res = rng.standard_normal((b, h, block_n, d)).astype(np.float32)
    v_res = rng.standard_normal((b, h, block_n, d)).astype(np.float32)
    res_len = np.array([3, block_n - 1, 0], np.int32)
    jc = dataclasses.replace(jc, k_res=bf16(k_res), v_res=bf16(v_res),
                             res_len=jnp.asarray(res_len),
                             pack_blocks=jnp.asarray([1, 2, 0], jnp.int32))
    for f in ("k_res", "v_res", "res_len", "pack_blocks"):
        getattr(tc, f).copy_(from_jax(getattr(jc, f)))
    jw = jq.widen_residual(jc, extra)
    tw = tq.widen_residual(tc, extra)
    tr = tq.widen_residual(tc, extra, multiple=8)  # the engine's rounded-up width
    assert tw.k_res.shape[-2] == block_n + extra and tr.k_res.shape[-2] == 24
    assert tq.widen_residual(tc, 0) is tc
    tw = dataclasses.replace(tw, res_len=tw.res_len.clone())
    tr = dataclasses.replace(tr, res_len=tr.res_len.clone())
    before = {f: getattr(tc, f).clone() for f in ("kw", "k_scale", "vw", "pack_blocks")}
    for step in range(extra):
        k_new = rng.standard_normal((b, h, 1, d)).astype(np.float32)
        v_new = rng.standard_normal((b, h, 1, d)).astype(np.float32)
        jw = jq.draft_append(jw, bf16(k_new), bf16(v_new))
        for t in (tw, tr):
            tq.draft_append(t, from_jax(bf16(k_new)), from_jax(bf16(v_new)))
        for f in ("k_res", "v_res", "res_len"):
            want = bits_of(from_jax(getattr(jw, f)))
            np.testing.assert_array_equal(bits_of(getattr(tw, f)), want, err_msg=f"{f} {step}")
            np.testing.assert_array_equal(bits_of(getattr(tr, f)[..., :block_n + extra, :]
                                                  if f != "res_len" else tr.res_len), want)
        for f in ("k_res", "v_res"):
            assert not getattr(tr, f)[..., block_n + extra:, :].any()
    for f, t in before.items():  # pools, pack_blocks and the engine's residual untouched
        assert torch.equal(getattr(tc, f), t), f
    np.testing.assert_array_equal(bits_of(tc.k_res), bits_of(from_jax(bf16(k_res))))
    np.testing.assert_array_equal(tc.res_len.numpy(), res_len)


# --------------------------------------------------------------------------
# the spec engine against itself (spec_k = 1)
# --------------------------------------------------------------------------


def _model(**cfg_kw):
    cfg = smoke_config("llama3-8b").with_(**{"kv_bits": 4, "kv_block": BLOCK, **cfg_kw})
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def attn_model():
    return _model()


@pytest.fixture(scope="module")
def attn_2bit_tensor():
    return _model(kv_bits=2, kv_gran="tensor")


def _workload(cfg, n=4, seed=42, max_new=(12, 20), make=Request):
    """Block-crossing prompts, so that verify scans straddle flushes."""
    rng = np.random.default_rng(seed)
    return [make(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(34, 48)))
                 .astype(np.int32), max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _run(model, params, reqs, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 128)
    engine = ServeEngine(model, params, device="cpu", **kw)
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    engine.close()
    return engine


def _streams(reqs):
    return {r.uid: (list(r.out_tokens), r.phase) for r in reqs}


_BASELINES: dict = {}


def _baseline(model, params, cfg, **kw):
    key = (id(model), tuple(sorted(kw.items())))
    if key not in _BASELINES:
        reqs = _workload(cfg, **kw)
        _run(model, params, reqs)
        _BASELINES[key] = _streams(reqs)
    return _BASELINES[key]


@pytest.mark.parametrize("spec_k", [2, 4])
@pytest.mark.parametrize("which", ["4bit_channel", "2bit_tensor"])
def test_spec_matches_sequential(request, spec_k, which):
    cfg, model, params = request.getfixturevalue(
        "attn_model" if which == "4bit_channel" else "attn_2bit_tensor")
    want = _baseline(model, params, cfg)
    reqs = _workload(cfg)
    engine = _run(model, params, reqs, spec_k=spec_k, audit_every=1)
    assert _streams(reqs) == want
    assert engine.spec_bits == 2  # the default min(2, kv_bits)
    s = engine.stats
    assert s["spec_cycles"] == s["steps"] > 0
    assert s["spec_draft_tokens"] == s["spec_accepted_tokens"] + s["spec_rejected_tokens"] > 0
    assert audit_engine(engine).ok


def test_spec_under_oversubscription_and_faults(attn_model):
    """Half the pages, expected reservations, failed allocations and forced
    preemptions: replay rows are teacher-forced through the verify pass and
    every stream still equals the sequential one."""
    cfg, model, params = attn_model
    want = _baseline(model, params, cfg, n=5, max_new=(24, 32))
    reqs = _workload(cfg, n=5, max_new=(24, 32))
    plan = FaultPlan(seed=5, alloc_fail=0.3, forced_preempt=0.15)
    engine = _run(model, params, reqs, spec_k=3, n_pages=2 + 3, reserve_policy="expected",
                  expected_quantile=0.0, faults=plan, audit_every=1)
    assert _streams(reqs) == want
    s = engine.stats
    assert s["preempted"] > 0 and s["preempt_remat_tokens"] > 0
    assert {e["site"] for e in plan.log} >= {"alloc_fail", "forced_preempt"}
    assert engine.pool.n_free == engine.pool.capacity and engine.pool.reserved == 0


def test_spec_poisoned_row(attn_model):
    """A poisoned cycle retires only its own request, ERRORED, after the fed
    token; the others keep their sequential streams."""
    cfg, model, params = attn_model
    want = _baseline(model, params, cfg)
    plan = FaultPlan(seed=1, fire_at={"poison_logits": (3,)}, max_fires={"poison_logits": 1})
    reqs = _workload(cfg)
    engine = _run(model, params, reqs, spec_k=3, faults=plan, audit_every=2)
    errored = [r for r in reqs if r.phase is Phase.ERRORED]
    assert len(errored) == 1 and "non-finite logits" in errored[0].error
    assert engine.stats["errored"] == 1
    bad = errored[0]
    assert bad.out_tokens == want[bad.uid][0][:len(bad.out_tokens)]
    assert {u: v for u, v in _streams(reqs).items() if u != bad.uid} == {
        u: v for u, v in want.items() if u != bad.uid}


@pytest.mark.parametrize("guard", [True, False])
def test_spec_guard_logits(attn_model, guard):
    """A verify row flagged non-finite (slot 0's first feed, cycle 4)
    retires its request ERRORED after the token that produced it when
    ``guard_logits`` is on; with it off the flag is ignored and every
    stream equals the sequential one."""
    cfg, model, params = attn_model
    want = _baseline(model, params, cfg)
    reqs = _workload(cfg)
    engine = ServeEngine(model, params, slots=2, max_seq=128, spec_k=3, guard_logits=guard,
                         device="cpu")
    replay = engine._verify.replay

    def flagged():
        replay()
        if engine._cycle == 4:
            engine._verify.finite[0, 0] = False

    engine._verify.replay = flagged
    for r in reqs:
        engine.submit(r)
    engine.run()
    errored = [r for r in reqs if r.phase is Phase.ERRORED]
    if not guard:
        assert not errored and _streams(reqs) == want
        return
    assert len(errored) == 1 and engine.stats["errored"] == 1
    bad = errored[0]
    assert bad.out_tokens == want[bad.uid][0][:len(bad.out_tokens)]


def test_spec_with_prefix_sharing(attn_model):
    """Requests sharing a prompt prefix: shared pages and suffix prefills
    interleave with speculative cycles; the streams equal an identically
    staggered sequential engine's."""
    cfg, model, params = attn_model
    rng = np.random.default_rng(9)
    stem = rng.integers(0, cfg.vocab, 2 * BLOCK + 7).astype(np.int32)

    def staggered(**kw):
        reqs = [Request(uid=i, prompt=stem.copy(), max_new_tokens=10) for i in range(3)]
        engine = ServeEngine(model, params, slots=2, max_seq=128, device="cpu", **kw)
        engine.submit(reqs[0])
        engine.step()
        engine.submit(reqs[1])
        engine.submit(reqs[2])
        engine.run()
        assert engine.stats["prefill_tokens_saved"] > 0
        return engine, reqs

    _, base = staggered()
    engine, reqs = staggered(spec_k=3, audit_every=1)
    assert _streams(reqs) == _streams(base)
    assert audit_engine(engine).ok


def test_spec_counters_conserved(attn_model):
    cfg, model, params = attn_model
    reqs = _workload(cfg)
    engine = _run(model, params, reqs, spec_k=3, audit_every=1, spec_bits=4)
    s = engine.stats
    assert s["spec_draft_tokens"] == s["spec_accepted_tokens"] + s["spec_rejected_tokens"]
    assert sum(r.spec_accepted for r in reqs) == s["spec_accepted_tokens"]
    assert sum(r.spec_rejected for r in reqs) == s["spec_rejected_tokens"]
    summ = engine.summary()
    assert summ["spec_accept_rate"] == s["spec_accepted_tokens"] / s["spec_draft_tokens"]
    assert s["decoded_tokens"] == sum(len(r.out_tokens) for r in reqs)
    # the audit sees a breach of conservation
    engine.metrics.inc("spec_draft_tokens")
    assert any("conservation" in v for v in audit_engine(engine).violations)


def test_spec_config_validation(attn_model):
    _, model, params = attn_model
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(model, params, spec_k=0, device="cpu")
    with pytest.raises(ValueError, match="spec_bits"):
        ServeEngine(model, params, spec_k=2, spec_bits=0, device="cpu")
    with pytest.raises(ValueError, match="spec_bits"):
        ServeEngine(model, params, spec_k=2, spec_bits=8, device="cpu")  # > kv_bits=4
    engine = ServeEngine(model, params, device="cpu")
    assert engine._draft is None and engine._verify is None
    assert "spec_accept_rate" not in engine.summary()
    engine = ServeEngine(model, params, spec_k=2, spec_bits=3, device="cpu")
    assert engine._draft.spec_bits == 3 and engine._verify.k == 2
    # the draft's residual is widened to the kernel's 8-token unit
    assert engine._draft.dstate["caches"][0].k_res.shape[-2] == BLOCK + 8


def test_spec_async_runtime_equals_sync(attn_model):
    """``spec_k > 1`` with ``async_runtime=True``: the speculative cycle runs
    unoverlapped (no captured single step), completions go through the
    background thread, and the streams equal the sync spec run and the
    sequential one."""
    cfg, model, params = attn_model
    want = _baseline(model, params, cfg)
    reqs = _workload(cfg)
    texts = {}
    engine = _run(model, params, reqs, spec_k=2, async_runtime=True, audit_every=1,
                  detokenizer=lambda toks: "|".join(map(str, toks)),
                  on_complete=lambda rec: texts.setdefault(rec.uid, rec.text))
    assert engine._runner is None and engine._completions is not None
    assert _streams(reqs) == want
    assert sorted(engine._completions.records) == [r.uid for r in reqs]
    assert texts == {r.uid: "|".join(map(str, r.out_tokens)) for r in reqs}
    assert engine.stats["completions_enqueued"] == len(reqs)


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_twin(attn_model):
    """The port's init carried to the JAX smoke model."""
    _, _, tparams = attn_model
    jcfg = jax_smoke("llama3-8b").with_(kv_bits=4, kv_block=BLOCK)
    return jcfg, jax_build(jcfg), jax.tree.map(to_jax, tparams)


def _state_to_jax(jmodel, tstate, n_pages, nb_max):
    b = tstate["pos"].shape[0]
    jstate = jmodel.init_paged_decode_state(b, n_pages=n_pages, nb_max=nb_max)
    caches = [dataclasses.replace(jc, **{f: to_jax(getattr(tc, f)) for f in tq._PAGED_FIELDS
                                         if f != "arrive"})
              for jc, tc in zip(jstate["caches"], tstate["caches"])]
    return {"caches": caches, "pos": to_jax(tstate["pos"])}


class _RecordingModel:
    """The model with each decode step's logits kept (the verify pass's)."""

    def __init__(self, model):
        self.model, self.rows = model, []

    def decode_step(self, *args, **kw):
        logits, st = self.model.decode_step(*args, **kw)
        self.rows.append(logits[:, 0].float().clone())
        return logits, st


def test_verify_pass_matches_jax(attn_model, jax_twin):
    """One verify pass of 4 feeds over 4 rows of a port engine's state: row
    0 fed the verify argmax chain itself (every draft accepted; its last
    append fills the residual, so the scan crosses a block boundary and
    flushes through a lookahead page), row 1 forced (a replay), row 2 fed
    random drafts (it dies at the first mismatch), row 3 idle.  The last
    step of row 0 reads the block its flush packed, whose codes may differ
    from JAX's where K/V do by an ulp (ROADMAP §C): there ``v`` may differ
    only at a near tie of the port's logits (JAX's token within rtol 2e-2 /
    atol 3e-1 of the port's best)."""
    cfg, model, params = attn_model
    jcfg, jmodel, jparams = jax_twin
    rng = np.random.default_rng(5)
    eng = ServeEngine(model, params, slots=4, max_seq=128, device="cpu")
    for uid, n in enumerate((BLOCK + 25, 2 * BLOCK - 2, BLOCK + 3)):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                           max_new_tokens=40))
    for _ in range(3):
        eng.step()
    eng._ensure_flush_pages(lookahead=dict.fromkeys(eng.sched.active, 4))
    from repro_torch.serve import pages as tpages
    tpages.set_page_tables(eng.state["caches"], eng._table)
    state = eng.state
    before = [{f: getattr(c, f).clone() for f in tq._PAGED_FIELDS} for c in state["caches"]]
    pos0 = state["pos"].clone()
    k = 4
    feeds = np.zeros((4, k), np.int32)
    feeds[:3, 0] = eng.tokens[:3, 0]
    feeds[1:3, 1:] = rng.integers(0, cfg.vocab, (2, k - 1))
    limit = np.array([k, k, 3, 0], np.int32)
    forced = np.array([True, True, False, False])
    jverify = jspec.make_verify_fn(jmodel, jmodel.paged_spec())

    def jrun(feeds, forced):
        jstate = _state_to_jax(jmodel, state, eng.n_pages, eng.nb_max)
        return jverify(jparams, jstate, jnp.asarray(feeds), jnp.asarray(limit),
                       jnp.asarray(forced))

    for j in range(1, k):  # row 0 forced: its feeds become its own argmax chain
        feeds[0, j] = np.asarray(jrun(feeds, forced)[0])[0, j - 1]
    forced[0] = False
    jv, japplied, jfinite, jstate = jrun(feeds, forced)

    rec = _RecordingModel(model)
    ver = VerifyPass(rec, params, state, model.paged_spec(), spec_k=k)
    ver.feeds.copy_(torch.from_numpy(feeds))
    ver.limit.copy_(torch.from_numpy(limit))
    ver.forced.copy_(torch.from_numpy(forced))
    ver.replay()
    jv = np.asarray(jv)
    np.testing.assert_array_equal(ver.v.numpy()[:, :k - 1], jv[:, :k - 1])
    for b in range(4):
        if ver.v[b, k - 1] != jv[b, k - 1]:
            row = rec.rows[k - 1][b]
            top = row.max().item()
            assert top - row[jv[b, k - 1]].item() <= TOL["atol"] + TOL["rtol"] * abs(top), b
    np.testing.assert_array_equal(ver.applied.numpy(), np.asarray(japplied))
    np.testing.assert_array_equal(ver.finite.numpy(), np.asarray(jfinite))
    applied = ver.applied.numpy()
    assert applied[0].all() and applied[1].all() and not applied[3].any()
    assert applied[2, 0] and not applied[2].all()
    np.testing.assert_array_equal(state["pos"].numpy(), pos0.numpy() + applied.sum(1))
    np.testing.assert_array_equal(state["pos"].numpy(), np.asarray(jstate["pos"]))
    crossed = False
    for tc, jc, old in zip(state["caches"], jstate["caches"], before):
        for f in ("pack_blocks", "res_len"):
            np.testing.assert_array_equal(bits_of(getattr(tc, f)), np.asarray(getattr(jc, f)))
        crossed |= bool((tc.pack_blocks != old["pack_blocks"]).any())
        for f in ("k_res", "v_res"):
            np.testing.assert_allclose(getattr(tc, f).float().numpy(),
                                       np.asarray(getattr(jc, f), np.float32), **OUT_TOL)
            # the idle row's residual is untouched
            assert torch.equal(getattr(tc, f)[:, 3], old[f][:, 3])
        for f in ("kw", "vw"):
            same = (getattr(tc, f).numpy() == np.asarray(getattr(jc, f))).mean()
            assert same >= 0.99, (f, same)
        assert torch.equal(tc.res_len[:, 3], old["res_len"][:, 3])
    assert crossed  # a flush inside the scan, behind a lookahead page


def test_spec_streams_match_jax_spec_engine(attn_model, jax_twin):
    """Same workload through the JAX spec engine and the port's, both at
    ``spec_k = 3``, on the carried parameters: the streams agree up to each
    request's first decode step that reads a block packed by a flush (the
    init-scale property, ROADMAP §C); a first difference before it must be
    a near tie of the port's logits (JAX's token within the tolerance)."""
    cfg, model, params = attn_model
    _, jmodel, jparams = jax_twin
    t_reqs = _workload(cfg)
    teng = _run(model, params, t_reqs, spec_k=3)
    j_reqs = _workload(cfg, make=JRequest)
    jeng = JServeEngine(jmodel, jparams, slots=2, max_seq=128, spec_k=3)
    for r in j_reqs:
        assert jeng.submit(r)
    jeng.run()
    assert teng.stats["decoded_tokens"] == jeng.stats["decoded_tokens"]
    for tr, jr in zip(t_reqs, j_reqs):
        first_read = BLOCK - tr.prompt_len % BLOCK
        mine, theirs = tr.out_tokens[:first_read], [int(t) for t in jr.out_tokens[:first_read]]
        d = next((i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b), None)
        if d is not None:
            row = _solo_rows(model, params, tr)[d]
            top = row.max().item()
            assert top - row[theirs[d]].item() <= TOL["atol"] + TOL["rtol"] * abs(top), (
                tr.uid, d, mine[d], theirs[d])


def _solo_rows(model, params, req):
    """The port's logits row behind each of ``req``'s tokens, from a solo
    sync run of its prompt (a row's result does not depend on the others)."""
    eng = ServeEngine(model, params, slots=2, max_seq=128, device="cpu")
    rows, prefill, step = [], eng._prefill, eng._step

    def on_prefill(toks, lens):
        logits, dstate = prefill(toks, lens)
        rows.append(logits[0, 0].float())
        return logits, dstate

    def on_step(p, s, t):
        logits, s = step(p, s, t)
        rows.append(logits[0, 0].float())
        return logits, s

    eng._prefill, eng._step = on_prefill, on_step
    solo = Request(uid=0, prompt=np.asarray(req.prompt).copy(), max_new_tokens=req.max_new_tokens)
    eng.submit(solo)
    eng.run()
    assert solo.out_tokens == req.out_tokens
    return rows


# --------------------------------------------------------------------------
# the rest of the engine's options, and the launcher
# --------------------------------------------------------------------------


def test_strict_raises_on_an_unadmittable_submission(attn_model):
    _, model, params = attn_model
    big = Request(uid=0, prompt=np.zeros(120, np.int32), max_new_tokens=20)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        ServeEngine(model, params, slots=2, max_seq=128, strict=True, device="cpu").submit(big)
    lax_ = ServeEngine(model, params, slots=2, max_seq=128, device="cpu")
    assert not lax_.submit(Request(uid=0, prompt=np.zeros(120, np.int32), max_new_tokens=20))


def test_metrics_every_feeds_the_sink(attn_model, capsys):
    cfg, model, params = attn_model
    snaps = []
    engine = _run(model, params, _workload(cfg, n=2), metrics_every=3,
                  metrics_sink=snaps.append)
    cycles = engine._cycle
    assert len(snaps) == cycles // 3 > 0
    assert snaps[-1]["counters"]["decoded_tokens"] <= engine.stats["decoded_tokens"]
    _run(model, params, _workload(cfg, n=1, max_new=(3, 4)), metrics_every=2)
    assert "# TYPE repro_serve_decoded_tokens counter" in capsys.readouterr().out


CLI = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
       "--prompt-len", "40", "--max-new", "8", "--max-seq", "128", "--audit-every", "1"]


def test_serve_cli_speculative(capsys):
    stats = launch_serve.main([*CLI, "--spec-k", "4", "--spec-bits", "2"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("[serve] speculative:"))
    assert line.startswith("[serve] speculative: k=4 accept_rate=")
    assert f"drafted={stats['spec_draft_tokens']} accepted={stats['spec_accepted_tokens']}" in line
    assert stats["decoded_tokens"] == 24 and stats["spec_cycles"] > 0
    plain = launch_serve.main(CLI)
    assert plain["decoded_tokens"] == 24 and "spec_accept_rate" not in plain


def test_serve_cli_strict_and_metrics_every(capsys):
    stats = launch_serve.main([*CLI, "--strict", "--metrics-every", "2"])
    out = capsys.readouterr().out
    assert stats["decoded_tokens"] == 24
    assert out.count("# TYPE repro_serve_decoded_tokens counter") >= 2
    with pytest.raises(ValueError, match="exceeds max_seq"):
        launch_serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--requests",
                           "1", "--prompt-len", "40", "--max-seq", "32", "--strict"])
