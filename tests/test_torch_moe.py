"""The MoE decoder in the port against the JAX package, on the CPU, at the
smoke size, on the plain versions of the kernels.

* **``moe_ffn``** against JAX's ``moe.moe_ffn`` on the same inputs, made
  with numpy from a seed, with JAX-initialized parameters: the qwen3 smoke
  config, a capacity factor of 0.5 (tokens drop), the sigmoid router, a
  shared expert, a decode step (S = 1, capacity 1), a ragged S and top-4
  (a token's four terms summed in order).  The routing is equal (top-k
  experts, kept slots, buffer positions), the top-k weights within 1e-6,
  ``aux`` within 1e-5 and ``out`` within rtol / atol 1e-2 (here ``out``
  comes out bit for bit in every case; the test holds only the
  tolerance).  The combine alone against JAX's bf16 scatter-add, bit for
  bit.
* **The port's versions of ``tests/test_moe.py``**: against a dense
  per-expert loop, drops bounded, a shared expert.
* **``qk_norm``**: ``_qkv`` against JAX's, bit for bit.
* **The model**: the parameter trees of the qwen3 configs (SMOKE, CONFIG
  and a dense-then-MoE variant) leaf for leaf; the dense-then-MoE model
  (two stacks) through prefill and 20 decode steps against JAX within the
  family tests' tolerance (rtol 2e-2 / atol 3e-1).
* **The engine** on the qwen3 smoke model and on its dense-then-MoE
  variant (two stacks), over a workload with a shared prefix and a copy
  on write: its streams equal ``DecoderLM``'s greedy decoding of each
  prompt prefilled at the engine's padded length (the capacity follows the
  padded length, as in JAX); the async runtime and a preempting pool
  equal the sync, unpressured streams bit for bit; the launcher serves
  the qwen3 smoke model.

The JAX model is compiled as the program is written
(``xla_allow_excess_precision`` off, ``tests/test_torch_family.py``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
from repro.configs.base import get_config as jax_config
from repro.configs.base import smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.params import init_tree
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.params import init_tree as init_torch
from repro_torch.models.params import leaves
from repro_torch.models.zoo import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import bucket_for

ARCH = "qwen3-moe-235b-a22b"
TOL = dict(rtol=2e-2, atol=3e-1)  # the family tests' logits tolerance
OUT_TOL = dict(rtol=1e-2, atol=1e-2)
BLOCK = 32
DENSE_FIRST = dict(first_dense_layers=1, d_ff=256)  # an MLP stack, then an MoE stack
SHARER, COW = 1, 2  # the engine workload's requests that share request 0's pages
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


def _bf16_pair(x: np.ndarray):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# --------------------------------------------------------------------------
# moe_ffn against JAX's
# --------------------------------------------------------------------------

CASES = {  # config change, B, S
    "smoke": ({}, 2, 32),
    "drops": (dict(capacity_factor=0.5), 2, 32),
    "sigmoid": (dict(router_score="sigmoid"), 2, 32),
    "shared": (dict(n_shared_experts=1), 2, 32),
    "decode": ({}, 4, 1),
    "ragged": ({}, 3, 37),
    "top4": (dict(top_k=4), 2, 32),
}


def _jax_routing(p, cfg, x):
    """The reference's routing (``repro/models/moe.py:50-64``): top-k
    weights and experts, each flattened slot's buffer position and whether
    it is kept."""
    b, s, _ = x.shape
    cap = jmoe._capacity(cfg, s)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"])
    if cfg.router_score == "sigmoid":
        scores = jax.nn.sigmoid(logits)
    else:
        scores = jax.nn.softmax(logits, axis=-1)
    top_w, top_e = jax.lax.top_k(scores, cfg.top_k)
    if cfg.router_norm_topk:
        top_w = top_w / (jnp.sum(top_w, axis=-1, keepdims=True) + 1e-9)
    onehot = jax.nn.one_hot(top_e.reshape(b, -1), cfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1
    return top_w, top_e, pos, (pos >= 0) & (pos < cap)


def _moe_pair(change, seed=0):
    jcfg, tcfg = jax_smoke(ARCH).with_(**change), smoke_config(ARCH).with_(**change)
    jp = init_tree(jmoe.moe_def(jcfg), jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    change, b, s = CASES[case]
    jcfg, tcfg, jp, tp = _moe_pair(change)
    x = np.random.default_rng(1).standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    xj, xt = _bf16_pair(x)
    out_j, aux_j = jax.jit(lambda p, x: jmoe.moe_ffn(p, jcfg, x))(jp, xj)
    jw, je, jpos, jkeep = jax.jit(lambda p, x: _jax_routing(p, jcfg, x))(jp, xj)
    with torch.no_grad():
        out_t, aux_t = tmoe.moe_ffn(tp, tcfg, xt)
        cap = tmoe.capacity(tcfg, s)
        _, tw, te = tmoe.route(tp, tcfg, xt)
        _, tpos, tkeep = tmoe.slots(te, tcfg.n_experts, cap)
    assert cap == jmoe._capacity(jcfg, s)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=0, atol=1e-5)
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (b, s, tcfg.d_model)
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32), **OUT_TOL)
    dropped = int((~tkeep).sum())
    if case == "drops":
        assert dropped > 0
    elif case == "decode":
        assert cap == 1 and dropped == 0


def test_combine_adds_in_top_k_order_like_jax_bitwise():
    """Four terms a token, each ``vals * w`` in bf16, added one at a time
    in top-k order: JAX's bf16 scatter-add; a sum in f32 differs."""
    rng = np.random.default_rng(2)
    b, s, k, d, e, cap = 2, 16, 4, 64, 8, 6
    top_e = np.stack([rng.permutation(e)[:k] for _ in range(b * s)]).reshape(b, s, k)
    top_w = rng.random((b, s, k)).astype(np.float32)
    ye = rng.standard_normal((b, e, cap, d)).astype(np.float32) * 3
    te = torch.from_numpy(top_e)
    _, pos, keep = tmoe.slots(te, e, cap)
    # the port's buffers hold expert e's rows of group b at (e * B + b) * cap
    ye_t = torch.from_numpy(ye).to(torch.bfloat16).transpose(0, 1).reshape(e, b * cap, d)
    row = (te.flatten(1) * b + torch.arange(b)[:, None]) * cap + pos.clamp(max=cap - 1)
    out_t = tmoe.combine(ye_t, row, keep, torch.from_numpy(top_w), (b, s, d))

    def jax_combine(ye_g, wg, eg, pos, keep):
        flat_e = eg.reshape(-1)
        vals = jnp.where(keep[:, None], ye_g[flat_e, jnp.clip(pos, 0, cap - 1)], 0)
        src = jnp.repeat(jnp.arange(s), k)
        w = wg.reshape(-1)[:, None].astype(vals.dtype)
        return jnp.zeros((s, d), vals.dtype).at[src].add(vals * w)

    out_j = jax.jit(jax.vmap(jax_combine))(
        jnp.asarray(ye, jnp.bfloat16), jnp.asarray(top_w), jnp.asarray(top_e),
        jnp.asarray(pos.numpy()), jnp.asarray(keep.numpy()))
    np.testing.assert_array_equal(_bits(out_t), _bits(out_j))
    f32 = (torch.where(keep.view(b, s, k, 1), ye_t.reshape(-1, d)[row.flatten()].view(b, s, k, d),
                       0) * torch.from_numpy(top_w).to(torch.bfloat16)[..., None]).float().sum(2)
    assert not np.array_equal(_bits(f32.to(torch.bfloat16)), _bits(out_j))


# --------------------------------------------------------------------------
# tests/test_moe.py in the port
# --------------------------------------------------------------------------


def _small_cfg(cf=8.0):
    return smoke_config(ARCH).with_(d_model=32, n_experts=4, top_k=2, d_expert=16,
                                    capacity_factor=cf)


def _small_moe(cfg, shape, seed=0):
    p = init_torch(tmoe.moe_def(cfg), torch.Generator().manual_seed(seed), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    return p, torch.from_numpy(x).to(torch.bfloat16)


def _dense_reference(p, cfg, x):
    """Same routing, no capacity, an explicit loop over the experts."""
    _, top_w, top_e = tmoe.route(p, cfg, x)
    out = torch.zeros(x.shape, dtype=torch.float32)
    for e in range(cfg.n_experts):
        u, g = torch.matmul(x, p["wi"][e]).chunk(2, dim=-1)
        y = torch.matmul(u * torch.nn.functional.silu(g), p["wo"][e]).float()
        w = torch.where(top_e == e, top_w, 0.0).sum(-1)
        out += w[..., None] * y
    return out


def test_moe_matches_dense_reference():
    cfg = _small_cfg(cf=8.0)  # capacity high enough that nothing drops
    p, x = _small_moe(cfg, (2, 16, 32))
    with torch.no_grad():
        out, aux = tmoe.moe_ffn(p, cfg, x)
        ref = _dense_reference(p, cfg, x)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=5e-2, atol=5e-2)
    assert np.isfinite(float(aux)) and float(aux) > 0


def test_moe_capacity_drops_are_bounded():
    cfg = _small_cfg(cf=0.5)  # tight capacity: some tokens must drop, output finite
    p, x = _small_moe(cfg, (2, 32, 32))
    with torch.no_grad():
        out, _ = tmoe.moe_ffn(p, cfg, x)
        ref = _dense_reference(p, cfg, x)
        _, _, top_e = tmoe.route(p, cfg, x)
        keep = tmoe.slots(top_e, cfg.n_experts, tmoe.capacity(cfg, 32))[2]
    assert not bool(keep.all())
    assert torch.isfinite(out.float()).all()
    # dropped tokens contribute zero, so the norm is below the no-drop reference's
    assert out.float().norm() <= ref.norm() * 1.2


def test_moe_shared_expert():
    cfg = _small_cfg(cf=8.0).with_(n_shared_experts=1)
    p, x = _small_moe(cfg, (1, 8, 32))
    assert set(p) == {"router", "wi", "wo", "shared"}
    with torch.no_grad():
        out, _ = tmoe.moe_ffn(p, cfg, x)
        alone, _ = tmoe.moe_ffn(p, cfg.with_(n_shared_experts=0), x)
    assert out.shape == x.shape
    assert not torch.equal(out, alone)


# --------------------------------------------------------------------------
# qk_norm and the model
# --------------------------------------------------------------------------


def test_qk_norm_qkv_matches_jax_bitwise():
    tcfg, jcfg = smoke_config(ARCH), jax_smoke(ARCH)
    stacked = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")["stack_0"]["attn"]
    p = {k: v[0] for k, v in stacked.items() if k not in ("qnorm", "knorm")}
    # norm weights away from one, so the scale is exercised
    g = torch.Generator().manual_seed(1)
    for name in ("qnorm", "knorm"):
        p[name] = {"w": 1.0 + 0.5 * torch.randn(tcfg.head_dim, generator=g)}
    x = np.random.default_rng(3).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    xj, xt = _bf16_pair(x)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32) + 5, (2, 24)).copy()
    qj, kj, vj = jit_as_written(lambda p, x, ps: jattn._qkv(p, jcfg, x, ps))(
        jax.tree.map(_to_jax, p), xj, jnp.asarray(pos))
    qt, kt, vt = tattn._qkv(p, tcfg, xt, torch.from_numpy(pos))
    for t, j in ((qt, qj), (kt, kj), (vt, vj)):
        np.testing.assert_array_equal(_bits(t), _bits(j))


def _jax_leaves(tree):
    return {tuple(getattr(k, "key", k) for k in kp): (tuple(v.shape), str(v.dtype))
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("which", ["smoke", "config", "dense_first"])
def test_param_defs_match_jax(which):
    """Leaf for leaf, shape and dtype, without drawing the full config."""
    if which == "config":
        tcfg, jcfg = get_config(ARCH), jax_config(ARCH)
    else:
        change = DENSE_FIRST if which == "dense_first" else {}
        tcfg, jcfg = smoke_config(ARCH).with_(**change), jax_smoke(ARCH).with_(**change)
    tm, jm = build_model(tcfg), jax_build(jcfg)
    assert tm.stacks == jm.stacks
    ours = {path: (p.shape, str(p.dtype).replace("torch.", "")) for path, p in
            leaves(tm.param_defs())}
    assert ours == _jax_leaves(jm.param_shapes())
    assert tm.paged_spec().page_layers == tcfg.n_layers


def test_dense_then_moe_matches_jax():
    """``first_dense_layers = 1`` with a ``d_ff``: an MLP stack, then an MoE
    stack, each with its own caches.  JAX's init through ``params_from_jax``
    (checked) and the port's init carried to JAX; ragged prefill logits and
    20 decode steps across a flush, fed the JAX tokens."""
    jcfg, tcfg = jax_smoke(ARCH).with_(**DENSE_FIRST), smoke_config(ARCH).with_(**DENSE_FIRST)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    assert tm.stacks == [("mlp", 1), ("moe", 1)]
    jinit = jm.init(jax.random.PRNGKey(0))
    carried = params_from_jax(jax.tree.map(np.asarray, jinit), tcfg)
    for path, _ in leaves(tm.param_defs()):
        t, j = carried, jinit
        for key in path:
            t, j = t[key], j[key]
        np.testing.assert_array_equal(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                                      else t.numpy(), _bits(j) if t.dtype == torch.bfloat16
                                      else np.asarray(j))
    tparams = tm.init(torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(_to_jax, tparams)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab, size=(2, 48), dtype=np.int32)
    lengths = np.array([48, 37], np.int32)
    jl, jstate = jit_as_written(lambda p, t: jm.prefill(p, {"tokens": t}, 256,
                                                        lengths=jnp.asarray(lengths)))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tstate = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, 256,
                                lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **TOL)
    step = jit_as_written(jm.decode_step)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(20):
        jl, jstate = step(jparams, jstate, tok)
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    assert len(tstate["caches"]) == 2
    for tc, jc in zip(tstate["caches"], jstate["caches"]):
        np.testing.assert_array_equal(tc.pack_blocks.numpy(), np.asarray(jc.pack_blocks))
        np.testing.assert_array_equal(tc.res_len.numpy(), np.asarray(jc.res_len))
    assert tstate["caches"][0].pack_blocks[0].tolist() == [1, 0]  # the 48-token row flushed


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["moe", "dense_first"])
def moe_model(request):
    """The qwen3 smoke model (one MoE stack) and its dense-then-MoE variant
    (two stacks, each with its own caches and pools)."""
    change = DENSE_FIRST if request.param == "dense_first" else {}
    cfg = smoke_config(ARCH).with_(kv_bits=4, kv_block=BLOCK, **change)
    model = build_model(cfg)
    assert len(model.stacks) == (2 if change else 1)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


def _workload(cfg, n=5):
    """``n`` requests of 34-47 tokens.  Request ``SHARER`` begins with
    request 0's first block (a suffix prefill over that block, dequantized
    from every stack's pool); request ``COW`` is request 0's first 8 tokens
    (it takes request 0's block as its flush page and copies it on write at
    its first flush)."""
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(34, 48))).astype(np.int32)
               for _ in range(n)]
    prompts[SHARER][:BLOCK] = prompts[0][:BLOCK]
    prompts[COW] = prompts[0][:8].copy()
    return [Request(uid=i, prompt=p, max_new_tokens=int(rng.integers(24, 32)))
            for i, p in enumerate(prompts)]


def _serve(model, params, reqs, **kw):
    """Request 0 first, the rest after one cycle (request 0's pages then
    hold its prompt for the sharers)."""
    kw.setdefault("slots", 3)
    kw.setdefault("max_seq", 128)
    engine = ServeEngine(model, params, device="cpu", **kw)
    assert engine.submit(reqs[0])
    engine.step()
    for r in reqs[1:]:
        assert engine.submit(r)
    stats = engine.run()
    engine.close()
    assert all(r.done for r in reqs)
    assert engine.pool.n_free == engine.pool.capacity
    return {r.uid: list(r.out_tokens) for r in reqs}, stats | {
        "cow_copies": engine.stats["cow_copies"],
        "prefix_hit_blocks": engine.sched.stats["prefix_hit_blocks"]}


@pytest.fixture(scope="module")
def baseline(moe_model):
    cfg, model, params = moe_model
    out, stats = _serve(model, params, _workload(cfg))
    assert stats["prefix_hit_blocks"] > 0 and stats["cow_copies"] > 0  # both sharers shared
    return out


def test_engine_matches_greedy_decoding(moe_model, baseline):
    """Each stream equals ``DecoderLM``'s greedy decoding of its prompt,
    prefilled right-padded to the engine's bucket (``lengths`` marks the
    real tokens): the MoE's capacity follows the padded length, as in
    JAX.  Request ``SHARER``'s prefill reads a dequantized prior instead:
    it is held to the other runs' streams below."""
    cfg, model, params = moe_model
    for r in _workload(cfg):
        if r.uid == SHARER:
            continue
        n = len(r.prompt)
        toks = np.zeros((1, bucket_for(n)), np.int64)
        toks[0, :n] = r.prompt
        with torch.no_grad():
            logits, st = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 128,
                                       lengths=torch.tensor([n], dtype=torch.int32))
            tok, out = int(logits[0, -1].argmax()), []
            for _ in range(r.max_new_tokens):
                out.append(tok)
                logits, st = model.decode_step(params, st, torch.tensor([[tok]]))
                tok = int(logits[0, 0].argmax())
        assert baseline[r.uid] == out, r.uid


def test_async_runtime_equals_sync(moe_model, baseline):
    cfg, model, params = moe_model
    out, stats = _serve(model, params, _workload(cfg), async_runtime=True)
    assert out == baseline and stats["completions_enqueued"] == len(baseline)
    assert stats["prefix_hit_blocks"] > 0 and stats["cow_copies"] > 0


def test_preempting_pool_equals_unpressured(moe_model, baseline):
    """Half the worst-case pages, expected-case reservations, audited every
    cycle: preemption fires, every stream equals the unpressured run's."""
    cfg, model, params = moe_model
    out, stats = _serve(model, params, _workload(cfg), n_pages=3 + 3,
                        reserve_policy="expected", expected_quantile=0.0, audit_every=1)
    assert stats["preempted"] > 0 and stats["prefix_hit_blocks"] > 0
    assert out == baseline


def test_serve_cli_serves_the_moe_smoke_model(capsys):
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--prompt-len", "40", "--max-new", "6",
                       "--max-seq", "128", "--audit-every", "1"])
    out = capsys.readouterr().out
    assert "[serve] engine mode: paged, pool=" in out
    stats = next(line for line in out.splitlines() if line.startswith("[serve] {"))
    assert "'decoded_tokens': 18" in stats
