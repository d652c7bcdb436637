"""The port's cross-device split-KV decode (``repro_torch.dist``) on the CPU,
on gloo ranks, against the JAX package's.

* One JAX subprocess (4 fake CPU devices, ``impl="xla"``, inputs from numpy
  seeds written to an ``.npz``) gives ``splitkv_decode_attention`` and
  ``splitkv_paged_decode_attention`` at 1, 2 and 4 shards; the port's
  functions on 1, 2 and 4 gloo ranks (``torch.multiprocessing``-free: one
  Python process a rank) match them within out 2e-2, every rank's output
  equal to rank 0's bit for bit, and at 1 rank equal to the unsplit call bit
  for bit.  The cases: ragged dense rows (one with no packed block, so a
  rank's window holds no valid block), paged, page-affine paged, the MLA
  latent (``shared_kv``, ``d_v``), and a block axis the ranks do not divide.
* The window of the plain K3/K4 and the page range of the plain K5 against
  the whole calls over the same slices.
* ``decode_state_specs`` against JAX's ``PartitionSpec``s field by field on
  an ``AbstractMesh``; ``pick_batch_axes``, ``splitkv_block_align`` against
  JAX's; the ``use_splitkv`` routing (a draft read stays unsplit except over
  page-affine pools).
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import attention as catt
from repro_torch.core import qcache
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.paged_bitdecode import ops as pg_ops
from repro_torch.kernels.residual_flush import ops as rf_ops

ROOT = Path(__file__).resolve().parent.parent
OUT_TOL = dict(rtol=2e-2, atol=2e-2)
SHARDS = (1, 2, 4)

# --------------------------------------------------------------------------
# gloo ranks: one Python process a rank, results through files
# --------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_RANK_MAIN = """
import sys
sys.path.insert(0, {tests!r})
import test_torch_dist
import {module} as m
test_torch_dist.rank_main(getattr(m, {fn!r}), {rank}, {n}, {port}, {out!r})
"""


def run_ranks(module: str, fn: str, n: int, out: Path, timeout: float = 400) -> list:
    """Run ``module.fn(mesh, rank, n, out)`` on ``n`` gloo ranks (a 1-D mesh
    over axis "data"); returns each rank's result (``torch.save``d)."""
    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN.format(tests=str(ROOT / "tests"), module=module,
                                                 fn=fn, rank=r, n=n, port=port, out=str(out))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


def rank_main(fn, rank: int, n: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank)
    try:
        mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("data",))
        result = fn(mesh, rank, n, Path(out))
        torch.save(result, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the JAX reference: one subprocess, 4 fake devices
# --------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import qcache
    from repro.dist.splitkv import splitkv_decode_attention, splitkv_paged_decode_attention

    out_path = sys.argv[1]
    BLOCK, BITS = 32, 4
    saved = {}

    def u16(x):
        return np.asarray(x).view(np.uint16)

    def bf16(rng, shape, scale=1.0):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                           jnp.bfloat16)

    def dense_case(name, seed, b, h, g, d, nblk, lengths, shared=False, d_v=None):
        rng = np.random.default_rng(seed)
        s = nblk * BLOCK
        k = bf16(rng, (b, h, s, d))
        v = None if shared else bf16(rng, (b, h, s, d))
        q = bf16(rng, (b, 1, h * g, d))
        cache = qcache.init_cache(b, h, d, s, bits=BITS, block_n=BLOCK, shared_kv=shared)
        cache = jax.jit(lambda c, k, v, n: qcache.prefill(c, k, v, lengths=n, quant_impl="xla"))(
            cache, k, v, jnp.asarray(lengths, jnp.int32))
        saved[name + "/q"] = u16(q)
        for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res",
                  "pack_blocks", "res_len"):
            x = getattr(cache, f)
            if x is not None:
                saved[f"{name}/{f}"] = u16(x) if x.dtype == jnp.bfloat16 else np.asarray(x)
        for n in (1, 2, 4):
            mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
            out = jax.jit(lambda q, c: splitkv_decode_attention(  # eager shard_map is slow
                q, c, mesh, axis="data", impl="xla", d_v=d_v))(q, cache)
            saved[f"{name}/out{n}"] = np.asarray(out, np.float32)
        return cache, q

    def paged_case(name, cache, q, affine):
        # page of (row b, column j) = j * B + b: column j's pages lie in shard
        # j // nb_local for every shard count dividing nb (page affinity)
        b, h, nblk = cache.kw.shape[:3]
        n_pages = nblk * b
        table = np.zeros((b, nblk), np.int32)
        pools = {}
        for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero"):
            x = getattr(cache, f)
            if x is None:
                continue
            x = np.asarray(x)
            pool = np.zeros((n_pages, *x.shape[1:2], *x.shape[3:]), x.dtype)
            for r in range(b):
                for j in range(nblk):
                    pool[j * b + r] = x[r, :, j]
            pools[f] = pool
        for r in range(b):
            table[r] = np.arange(nblk) * b + r
        pc = qcache.init_paged_cache(n_pages, b, h, cache.kw.shape[-1], nblk, bits=BITS,
                                     block_n=BLOCK)
        pc = dataclasses.replace(
            pc, page_table=jnp.asarray(table), k_res=cache.k_res, v_res=cache.v_res,
            pack_blocks=cache.pack_blocks, res_len=cache.res_len,
            **{f: jnp.asarray(a) for f, a in pools.items()})
        saved[name + "/table"] = table
        for f, a in pools.items():
            saved[f"{name}/pool_{f}"] = a.view(np.uint16) if a.dtype.itemsize == 2 else a
        for n in (1, 2, 4):
            mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
            out = jax.jit(lambda q, c: splitkv_paged_decode_attention(
                q, c, mesh, axis="data", impl="xla", page_affine=affine))(q, pc)
            saved[f"{name}/out{n}"] = np.asarray(out, np.float32)

    # ragged rows: a residual-only row (no packed block: every rank but the
    # last holds no valid block of it), one block, a full row
    dense, q = dense_case("dense", 0, 3, 2, 4, 128, 8, [20, 45, 8 * 32 - 3])
    paged_case("paged", dense, q, False)
    paged_case("affine", dense, q, True)
    dense_case("latent", 1, 2, 1, 4, 160, 8, [100, 8 * 32 - 9], shared=True, d_v=128)
    dense_case("ragged_axis", 2, 2, 2, 2, 64, 6, [60, 6 * 32 - 1])  # nb 6 over 4 ranks
    np.savez(out_path, **saved)
    print("OK")
""")

CASES = ("dense", "paged", "affine", "latent", "ragged_axis")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_splitkv") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype == np.uint16 \
        else torch.from_numpy(np.ascontiguousarray(a))


def case_inputs(ref: dict, name: str):
    """(q, cache, d_v) of a case, the port's cache from JAX's arrays."""
    src = "dense" if name in ("paged", "affine") else name
    q = _t(ref[f"{src}/q"])
    get = {f: _t(ref[f"{src}/{f}"]) if f"{src}/{f}" in ref else None
           for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res",
                     "pack_blocks", "res_len")}
    shared = get["vw"] is None
    d_v = 128 if shared else None
    b = get["kw"].shape[0]
    if name in ("paged", "affine"):
        pools = {f: _t(ref[f"{name}/pool_{f}"]) for f in ("kw", "k_scale", "k_zero", "vw",
                                                           "v_scale", "v_zero")}
        cache = qcache.PagedQuantKVCache(
            **pools, k_res=get["k_res"], v_res=get["v_res"],
            page_table=_t(ref[f"{name}/table"]), pack_blocks=get["pack_blocks"],
            res_len=get["res_len"], arrive=torch.zeros(b, dtype=torch.int32), bits=4,
            block_n=32, k_gran="channel")
    else:
        cache = qcache.QuantKVCache(**get, arrive=torch.zeros(b, dtype=torch.int32), bits=4,
                                    block_n=32, k_gran="channel", shared_kv=shared)
    return q, cache, d_v


def split_cases(mesh, rank, n, out):
    """Each case through the port's split functions on this rank, and at one
    rank the unsplit call beside it; under ``use_splitkv`` the routed call
    and a draft read beside them."""
    from repro_torch.dist import splitkv as sk

    with np.load(out.parent / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    got = {}
    for name in CASES:
        q, cache, d_v = case_inputs(ref, name)
        if name in ("paged", "affine"):
            got[name] = sk.splitkv_paged_decode_attention(
                q, cache, mesh, d_v=d_v, impl="torch", page_affine=name == "affine")
            with catt.use_splitkv(mesh, "data", page_affine=name == "affine"):
                got[name + "/routed"] = catt.decode_attention(q, cache, d_v=d_v, impl="torch")
                got[name + "/draft"] = catt.decode_attention(q, cache, d_v=d_v, impl="torch",
                                                             draft_bits=2)
        else:
            got[name] = sk.splitkv_decode_attention(q, cache, mesh, d_v=d_v, impl="torch")
            with catt.use_splitkv(mesh, "data"):
                got[name + "/routed"] = catt.decode_attention(q, cache, d_v=d_v, impl="torch")
                got[name + "/draft"] = catt.decode_attention(q, cache, d_v=d_v, impl="torch",
                                                             draft_bits=2)
        got[name + "/unsplit"] = catt.decode_attention(q, cache, d_v=d_v, impl="torch")
        got[name + "/unsplit_draft"] = catt.decode_attention(q, cache, d_v=d_v, impl="torch",
                                                             draft_bits=2)
        if name == "affine":  # the rank's own page range, as the engine holds it
            from repro_torch.dist.state_specs import local_pools

            specs = {"caches": [dataclasses.replace(cache, **{
                f: (_shard0,) for f in qcache._PAGED_POOL_FIELDS})]}
            mine = local_pools({"caches": [cache]}, specs, mesh, "data")["caches"][0]
            assert mine.n_pages == cache.n_pages // n and mine.page_lo == rank * mine.n_pages
            got[name + "/local"] = sk.splitkv_paged_decode_attention(
                q, mine, mesh, impl="torch", page_affine=True)
    return got


_shard0 = __import__("torch.distributed.tensor", fromlist=["Shard"]).Shard(0)


@pytest.fixture(scope="module")
def port_runs(jax_ref, tmp_path_factory):
    base = tmp_path_factory.mktemp("port_splitkv")
    np.savez(base / "ref.npz", **jax_ref)
    return {n: run_ranks("test_torch_dist", "split_cases", n, base / f"n{n}") for n in SHARDS}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name", CASES)
def test_split_walk_matches_jax(jax_ref, port_runs, name, n):
    """The port's split walk at n ranks against JAX's at n shards (out
    2e-2), every rank's bits equal to rank 0's, the ``use_splitkv`` route
    the same call; a page-affine rank holding its own page range alone
    reads the same bits as one walking its share of the whole pools."""
    ranks = port_runs[n]
    want = jax_ref[f"{name}/out{n}"]
    got = ranks[0][name]
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    for r, res in enumerate(ranks):
        assert torch.equal(res[name], got), f"rank {r} differs from rank 0"
        assert torch.equal(res[name + "/routed"], got)
        if name == "affine":
            assert torch.equal(res[name + "/local"], got)


@pytest.mark.parametrize("name", CASES)
def test_one_rank_equals_the_unsplit_call(port_runs, name):
    """At one rank the window is the whole cache and the merge of one partial
    is o * exp(0) / 1: the split walk equals the unsplit call bit for bit."""
    res = port_runs[1][0]
    assert torch.equal(res[name], res[name + "/unsplit"])


@pytest.mark.parametrize("name", CASES)
def test_draft_read_routes_only_over_affine_pools(port_runs, name):
    """Under ``use_splitkv`` a draft read stays unsplit (JAX's rule) except
    over page-affine pools, where no rank holds every page: there it walks
    split, within the tolerance of the unsplit draft read."""
    for res in port_runs[4]:
        if name == "affine":
            np.testing.assert_allclose(res[name + "/draft"].numpy(),
                                       res[name + "/unsplit_draft"].numpy(), **OUT_TOL)
        else:
            assert torch.equal(res[name + "/draft"], res[name + "/unsplit_draft"])


# --------------------------------------------------------------------------
# the plain versions' windows and page range against the whole calls
# --------------------------------------------------------------------------


def _filled_cache(seed, b=3, h=2, d=64, nblk=6, lengths=(20, 70, 6 * 32 - 5)):
    g = torch.Generator().manual_seed(seed)
    s = nblk * 32
    k = torch.randn((b, h, s, d), generator=g).to(torch.bfloat16)
    v = torch.randn((b, h, s, d), generator=g).to(torch.bfloat16)
    cache = qcache.init_cache(b, h, d, s, bits=4, block_n=32, device="cpu")
    qcache.prefill(cache, k, v, lengths=torch.tensor(lengths), quant_impl="torch")
    q = torch.randn((b, h, 2, d), generator=g).to(torch.bfloat16)
    return q, cache


@pytest.mark.parametrize("lo, width, res", [(0, None, True), (2, 2, False), (4, 2, True),
                                            (5, 3, True), (6, 2, False), (0, 6, False)])
def test_plain_k3_window_is_the_call_over_the_slice(lo, width, res):
    """K3's plain version over a window equals the whole call over a copy of
    that slice of the blocks, pack_blocks clipped to it, the residual read
    or dropped: bit for bit, out and lse."""
    q, c = _filled_cache(0)
    fields = (c.kw, c.k_scale, c.k_zero, c.vw, c.v_scale, c.v_zero)
    got = bd_ops.bitdecode_attention(q, *fields, c.k_res, c.v_res, c.pack_blocks, c.res_len,
                                     bits=4, block_n=32, impl="torch", return_lse=True,
                                     block_lo=lo, n_blocks=width, read_res=res)
    hi = 6 if width is None else min(6, lo + width)
    sl = [x[:, :, lo:hi].clone() for x in fields]
    pb = torch.clamp(c.pack_blocks - lo, 0, hi - lo)
    rl = c.res_len if res else torch.zeros_like(c.res_len)
    want = bd_ops.bitdecode_attention(q, *sl, c.k_res, c.v_res, pb, rl, bits=4, block_n=32,
                                      impl="torch", return_lse=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lo, width, page_lo", [(0, None, 0), (2, 2, 0), (3, 3, 6),
                                                (4, 4, 12)])
def test_plain_k4_window_and_page_lo(lo, width, page_lo):
    """K4's plain version over a column window with its pages rebased by
    ``page_lo`` equals the whole call over the sliced table and the pools'
    range, bit for bit."""
    q, c = _filled_cache(1)
    b, nblk = 3, 6
    perm = torch.randperm(b * nblk, generator=torch.Generator().manual_seed(3))
    table = perm.view(b, nblk).to(torch.int32)
    pools = []
    for x in (c.kw, c.k_scale, c.k_zero, c.vw, c.v_scale, c.v_zero):
        pool = torch.zeros((b * nblk, *x.shape[1:2], *x.shape[3:]), dtype=x.dtype)
        for r in range(b):
            for j in range(nblk):
                pool[table[r, j]] = x[r, :, j]
        pools.append(pool)
    hi = nblk if width is None else min(nblk, lo + width)
    local = [p[page_lo:page_lo + 6] for p in pools] if page_lo else pools
    got = pg_ops.paged_bitdecode_attention(
        q, *local, c.k_res, c.v_res, table, c.pack_blocks, c.res_len, bits=4, block_n=32,
        impl="torch", return_lse=True, block_lo=lo, n_blocks=width, page_lo=page_lo)
    sub = torch.clamp(table[:, lo:hi].long() - page_lo, 0, local[0].shape[0] - 1)
    want = pg_ops.paged_bitdecode_attention(
        q, *local, c.k_res, c.v_res, sub.to(torch.int32).contiguous(),
        torch.clamp(c.pack_blocks - lo, 0, hi - lo), c.res_len, bits=4, block_n=32,
        impl="torch", return_lse=True)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("page_lo", [0, 8, 24])
def test_plain_k5_page_range(page_lo):
    """K5's plain append over a page range: pages outside the range are never
    written, pages inside equal the whole-pool call's (rebased) bit for bit,
    and residuals and lengths equal on every range."""
    b, h, d, n_pages, nb_max = 4, 2, 64, 32, 6
    g = torch.Generator().manual_seed(5)
    table = (torch.randperm(n_pages - b, generator=g)[:b * nb_max] + b).view(b, nb_max)
    table = table.to(torch.int32)

    def fresh(pages):
        c = qcache.init_paged_cache(n_pages, b, h, d, nb_max, bits=4, block_n=32,
                                    device="cpu")
        c = dataclasses.replace(c, page_table=table)
        if pages < n_pages:
            c = dataclasses.replace(c, **{f: getattr(c, f)[page_lo:page_lo + pages].clone()
                                          for f in qcache._PAGED_POOL_FIELDS},
                                    page_lo=page_lo, pages_total=n_pages)
        return c

    whole, part = fresh(n_pages), fresh(8)
    for step in range(70):
        kn = torch.randn((b, h, 1, d), generator=g).to(torch.bfloat16)
        vn = torch.randn((b, h, 1, d), generator=g).to(torch.bfloat16)
        mask = torch.tensor([True, step % 4 != 0, True, True])
        for c in (whole, part):
            qcache.paged_append_decode(c, kn, vn, quant_impl="torch", mask=mask)
    for f in qcache._PAGED_POOL_FIELDS:
        assert torch.equal(getattr(part, f), getattr(whole, f)[page_lo:page_lo + 8]), f
    for f in ("k_res", "v_res", "pack_blocks", "res_len"):
        assert torch.equal(getattr(part, f), getattr(whole, f)), f
    assert int(whole.pack_blocks.sum()) > 4  # rows flushed, into pages of every range


def test_k5_page_range_is_checked():
    c = qcache.init_paged_cache(8, 2, 1, 64, 4, bits=4, block_n=32, device="cpu")
    kn = torch.zeros((2, 1, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="page range"):
        rf_ops._launch("paged_residual_flush", (c.kw,), b=2, h=1, n_cells=8, block_n=32,
                       bits=4, k_gran="channel", k_new=kn, page_lo=4, pages_total=8)


# --------------------------------------------------------------------------
# placements, meshes, alignment
# --------------------------------------------------------------------------


def _stand_in(shape, names):
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def _spec_of(placements: tuple, mesh, ndim: int) -> tuple:
    """The PartitionSpec-like tuple of ``placements`` over a tensor of
    ``ndim`` dims (the inverse of ``state_specs.to_placements``)."""
    from torch.distributed.tensor import Shard

    parts = []
    for i in range(ndim):
        names = tuple(n for n, p in zip(mesh.mesh_dim_names, placements)
                      if isinstance(p, Shard) and p.dim == i)
        parts.append(None if not names else names[0] if len(names) == 1 else names)
    return tuple(parts)


def _jax_spec(ps, ndim):
    parts = tuple(ps) + (None,) * (ndim - len(tuple(ps)))
    return tuple(None if e is None else e if isinstance(e, str) else tuple(e)
                 if len(e) > 1 else e[0] for e in parts)


@pytest.mark.parametrize("kw", [
    dict(global_batch=4, seq_ax="data", paged=True),
    dict(global_batch=4, seq_ax="data", paged=True, n_pages=16, nb_max=8, page_affine=True),
    dict(global_batch=8),
    dict(global_batch=1, seq_ax="data"),
])
@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_decode_state_specs_match_jax(arch, kw):
    """The port's placements are JAX's PartitionSpecs field by field, on a
    (4, 2) ("data", "model") AbstractMesh and its stand-in."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs.base import smoke_config as jax_smoke
    from repro.dist import state_specs as jspecs
    from repro.models.zoo import build_model as jax_build
    from repro_torch.configs import smoke_config
    from repro_torch.dist import state_specs as tspecs
    from repro_torch.models.zoo import build_model

    jmesh = AbstractMesh((4, 2), ("data", "model"))
    tmesh = _stand_in((4, 2), ("data", "model"))
    jtree = jspecs.decode_state_specs(jax_build(jax_smoke(arch)), jmesh, **kw)
    ttree = tspecs.decode_state_specs(build_model(smoke_config(arch)), tmesh, **kw)
    if kw.get("paged"):
        np_ = kw.get("n_pages") or kw["global_batch"] * ((kw.get("nb_max") or 4) + 1)
        state = build_model(smoke_config(arch)).init_paged_decode_state(
            kw["global_batch"], n_pages=np_, nb_max=kw.get("nb_max") or 4, device="meta")
    else:
        state = build_model(smoke_config(arch)).init_decode_state(
            kw["global_batch"], 4 * smoke_config(arch).kv_block, device="meta")
    compared = 0
    for jc, tc, sc in zip(jtree["caches"], ttree["caches"], state["caches"]):
        for f in dataclasses.fields(jc):
            js = getattr(jc, f.name)
            if not isinstance(js, jax.sharding.PartitionSpec):
                continue
            arr = getattr(sc, f.name)
            got = _spec_of(getattr(tc, f.name), tmesh, arr.dim())
            assert got == _jax_spec(js, arr.dim()), (f.name, got, js)
            compared += 1
    assert _spec_of(ttree["pos"], tmesh, 1) == _jax_spec(jtree["pos"], 1)
    assert compared >= 8


@pytest.mark.parametrize("shape, names, batch", [
    ((4, 2), ("data", "model"), 8), ((4, 2), ("data", "model"), 2),
    ((2, 4, 2), ("pod", "data", "model"), 16), ((2, 4, 2), ("pod", "data", "model"), 4),
    ((2, 4, 2), ("pod", "data", "model"), 3), ((16, 16), ("data", "model"), 1),
])
def test_pick_batch_axes_and_block_align_match_jax(shape, names, batch):
    from jax.sharding import AbstractMesh

    from repro.core import qcache as jq
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh

    jm, tm = AbstractMesh(shape, names), _stand_in(shape, names)
    assert tmesh.pick_batch_axes(tm, batch) == jmesh.pick_batch_axes(jm, batch)
    for axis in ("data", "pod", "nope", None):
        tm_sized = types.SimpleNamespace(mesh_dim_names=names, shape=shape,
                                         size=lambda i, s=shape: s[i])
        assert qcache.splitkv_block_align(tm_sized, axis) == jq.splitkv_block_align(jm, axis)
    assert qcache.splitkv_block_align(None, "data") is None


@pytest.mark.parametrize("n, mp", [(8, 16), (32, 16), (12, 8), (7, 4), (1, 16)])
def test_elastic_shape(n, mp):
    """The elastic mesh's (data, model) split: JAX's loop on n devices."""
    from repro_torch.launch.mesh import elastic_shape

    model = min(mp, n)
    while n % model:
        model -= 1
    assert elastic_shape(n, mp) == (n // model, model)


def test_mesh_aligned_allocation():
    """``init_decode_state(mesh=)`` rounds the block axis up to the split
    axis (5 blocks -> 8 over 4 ranks), dense and hybrid."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.zoo import build_model

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 2),
                                 size=lambda i: (4, 2)[i])
    for arch in ("llama3-8b", "zamba2-7b", "deepseek-v3-671b"):
        cfg = smoke_config(arch)
        model = build_model(cfg)
        st = model.init_decode_state(4, 5 * cfg.kv_block, mesh=mesh, splitkv_axis="data",
                                     device="meta")
        assert st["caches"][0].kw.shape[-3] == 8, arch
        st = model.init_decode_state(4, 5 * cfg.kv_block, device="meta")
        assert st["caches"][0].kw.shape[-3] == 5, arch


def test_mesh_without_the_axis_raises():
    from repro_torch.dist import splitkv as sk

    q, c = _filled_cache(0)
    mesh = types.SimpleNamespace(mesh_dim_names=("model",))
    with pytest.raises(ValueError, match="mesh has no axis 'data'"):
        sk.splitkv_decode_attention(q.reshape(3, 1, 4, 64), c, mesh)


def test_affine_pool_count_not_divisible_raises():
    """JAX's ValueError: page-affine pools whose page count the axis does not
    divide."""
    from repro_torch.dist import splitkv as sk

    c = qcache.init_paged_cache(6, 2, 1, 64, 4, bits=4, block_n=32, device="cpu")
    with pytest.raises(ValueError, match="divisible by the 'data' axis size"):
        sk.affine_pools(c, 4, 0, "data")
