"""The port's training pieces against the JAX package, on the CPU, at the
smoke size: the optimizers, the train step, the data pipeline, the
checkpoint manager and the launcher.

* **Optimizers**: given the same f32 gradients, AdamW's and Adafactor's
  ``update`` at steps 0, 1 and 150 (warmup and the cosine decay) against
  JAX's, compiled as written: the moments within 1e-6 relative L2 a leaf
  (measured <= 1.1e-7: XLA's CPU backend fuses ``b1 * m + (1 - b1) * g``
  into one FMA, the port rounds the product), the bf16 parameters bit for
  bit except one ulp on at most 0.1% of the elements (measured: none).
* **The train step**: ``make_train_step`` with 1 and 8 microbatches against
  one step of JAX's on the llama3 smoke config at step 150 (a nonzero
  learning rate): the loss and the gradient norm within 2e-3 relative, the
  moments within the gradients' 3e-2 relative L2, the parameters apart on
  at most 0.1% of the elements (measured 0.07%: where a gradient's sign
  differs) and there by at most the step's learning rate.
* **Data**: the port's generator fed JAX's own key gives JAX's batches bit
  for bit; the port's batches do not depend on ``PYTHONHASHSEED``, JAX's do
  (ROADMAP C); the prefetcher's order and its ``start_step``.
* **Checkpoints**: JAX's directories (one device, and 8 fake devices'
  shards) restore in the port bit for bit, bf16 included; the port writes
  JAX's files byte for byte, which JAX's manager restores bit for bit
  except bf16, which it restores from no directory, its own included
  (ROADMAP C); atomic commits, ``keep``, ``save_async``, ``latest_step``.
* **The launcher**: the CLI, a run with one injected failure and a
  ``--resume`` run bit for bit equal to an uninterrupted run, the refusals.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import smoke_config as jax_smoke
from repro.data import pipeline as jpipe
from repro.models.zoo import build_model as jax_build
from repro.optim import get_optimizer as jax_optimizer
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jax_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tmanager
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as launch_train
from repro_torch.models.zoo import build_model
from repro_torch.optim import get_optimizer
from repro_torch.train import tree as tr
from repro_torch.train.step import TrainState, make_train_step

ROOT = Path(__file__).resolve().parents[1]
MOMENT_REL_L2 = 1e-6
GRAD_REL_L2 = 3e-2
LOSS_RTOL = 2e-3
MAX_DIFF_SHARE = 1e-3  # at most 0.1% of the elements one ulp apart
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
    """A copy: a JAX array built on a CPU tensor's memory would alias it,
    and JAX's asynchronous dispatch would read it after an in-place
    update."""
    a = t.numpy() if t.dtype != torch.bfloat16 else (
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(np.array(a))


def bits_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want).astype(np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / max(np.linalg.norm(want), 1e-30))


def _moment_err(tstate, jstate) -> float:
    return max(_rel_l2(s, tr.get(jstate, path)) for path, s in tr.leaves_with_paths(tstate))


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------


def _opt_params(rng):
    shapes = {"w": (64, 48), "stack": (3, 32, 40), "b": (48,), "norm": (2, 32)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
              .to(torch.bfloat16) for k, s in shapes.items()}
    params["f32"] = torch.from_numpy(rng.standard_normal((16,)).astype(np.float32))
    return params


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(name):
    rng = np.random.default_rng(0)
    kw = dict(total_steps=300) if name == "adamw" else {}
    topt, jopt = get_optimizer(name, **kw), jax_optimizer(name, **kw)
    tparams = _opt_params(rng)
    jparams = tr.map_leaves(_to_jax, tparams)
    tstate, jstate = topt.init(tparams), jopt.init(jparams)
    jupdate = jit_as_written(jopt.update)
    for step in (0, 1, 150):
        grads = {k: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                 for k, p in tparams.items()}
        jup, jstate = jupdate(tr.map_leaves(_to_jax, grads), jstate, jparams, step)
        jparams = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jparams, jup)
        tup, tstate = topt.update(grads, tstate, tparams, step)
        for path, p in tr.leaves_with_paths(tparams):
            p.add_(tr.get(tup, path))
        assert _moment_err(tstate, jstate) <= MOMENT_REL_L2, step
        diff = total = 0
        for path, p in tr.leaves_with_paths(tparams):
            want = bits_of(tr.get(jparams, path)).astype(np.int64)
            d = np.abs(bits_of(p).astype(np.int64) - want)
            assert d.max() <= 1, (step, path)
            diff, total = diff + int((d > 0).sum()), total + d.size
        assert diff <= MAX_DIFF_SHARE * total, (step, diff, total)


def test_adafactor_state_is_factored_and_unknown_names_raise():
    st = get_optimizer("adafactor").init({"w": torch.zeros(64, 32), "b": torch.zeros(32)})
    assert st["w"]["row"].shape == (64,) and st["w"]["col"].shape == (32,)
    assert st["b"]["v"].shape == (32,)
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("sgd")


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 8])
def test_train_step_matches_jax(microbatches):
    arch, step = "llama3-8b", 150
    cfg = smoke_config(arch)
    model = build_model(cfg)
    batch = tpipe.make_batch(cfg, ShapeSpec("t", 32, 8, "train"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    before = tr.map_leaves(torch.clone, params)
    topt, jopt = get_optimizer("adamw", total_steps=300), jax_optimizer("adamw", total_steps=300)
    jparams = tr.map_leaves(_to_jax, params)
    jstate0 = JTrainState(jparams, jopt.init(jparams), jnp.int32(step))
    jf = jit_as_written(jax_train_step(jax_build(jax_smoke(arch)), jopt,
                                       microbatches=microbatches))
    jstate, jm = jf(jstate0, {k: _to_jax(v) for k, v in batch.items()})
    jax.block_until_ready(jstate)
    state, m = make_train_step(model, topt, microbatches=microbatches)(
        TrainState(params, topt.init(params), step), batch)
    assert state.step == step + 1 and state.params is params
    for key in ("loss", "grad_norm"):
        want = float(jm[key])
        assert abs(float(m[key]) - want) <= LOSS_RTOL * abs(want), key
    assert _moment_err(state.opt_state, jstate.opt_state) <= GRAD_REL_L2
    lr_peak = 3e-4  # AdamW's default peak rate bounds the step's
    diff = total = 0
    for path, p in tr.leaves_with_paths(params):
        got, want = p.float().numpy(), np.asarray(tr.get(jstate.params, path)).astype(np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= lr_peak + ulp), path
        diff, total = diff + int((got != want).sum()), total + got.size
        assert not torch.equal(p, tr.get(before, path)), path
    assert diff <= MAX_DIFF_SHARE * total, (diff, total)


def test_train_step_refuses_a_batch_that_does_not_split():
    cfg = smoke_config("llama3-8b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = get_optimizer("adamw")
    batch = tpipe.make_batch(cfg, ShapeSpec("t", 16, 6, "train"), device="cpu")
    with pytest.raises(ValueError, match="does not split into 4 microbatches"):
        make_train_step(model, opt, microbatches=4)(TrainState(params, opt.init(params), 0),
                                                    batch)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


def _jax_key(name, seed, step, index):
    """JAX's key, as its ``_gen_shard`` computes it, in this process."""
    return hash((name, seed, step, str(index))) % (2**31)


@pytest.mark.parametrize("arch", ["llama3-8b", "seamless-m4t-medium", "qwen2-vl-7b"])
def test_generator_fed_jax_key_gives_jax_batch(arch):
    cfg, jcfg = smoke_config(arch), jax_smoke(arch)
    for step, seed, seq in ((0, 0, 32), (5, 3, 48)):
        got = tpipe.make_batch(cfg, ShapeSpec("t", seq, 4, "train"), step=step, seed=seed,
                               device="cpu", key=_jax_key)
        want = jpipe.make_batch(jcfg, JShapeSpec("t", seq, 4, "train"), step=step, seed=seed)
        assert list(got) == list(want)
        for k, v in got.items():
            np.testing.assert_array_equal(bits_of(v), bits_of(want[k]), err_msg=k)


_DIGEST = """
import hashlib, numpy as np
from {pkg}.configs.base import ShapeSpec, smoke_config
from {pkg}.data.pipeline import make_batch
kw = {{"device": "cpu"}} if "{pkg}" == "repro_torch" else {{}}
b = make_batch(smoke_config("llama3-8b"), ShapeSpec("t", 32, 4, "train"), step=2, **kw)
print(hashlib.sha256(np.asarray(b["tokens"]).tobytes()).hexdigest())
"""


def _digest(pkg: str, hash_seed: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               PYTHONHASHSEED=hash_seed)
    r = subprocess.run([sys.executable, "-c", _DIGEST.format(pkg=pkg)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()[-1]


def test_batches_do_not_depend_on_the_hash_seed():
    """The port's batch of a step is the same in every process; JAX's
    follows the process's string-hash salt (ROADMAP C)."""
    assert _digest("repro_torch", "1") == _digest("repro_torch", "2")
    assert _digest("repro", "1") != _digest("repro", "2")


def test_prefetcher_order_and_start_step():
    cfg = smoke_config("llama3-8b")
    shape = ShapeSpec("t", 16, 2, "train")
    pre = tpipe.Prefetcher(cfg, shape, device="cpu", start_step=3, depth=2)
    try:
        for want in (3, 4, 5):
            step, batch = pre.next()
            assert step == want
            ref = tpipe.make_batch(cfg, shape, step=want, device="cpu")
            assert all(torch.equal(batch[k], ref[k]) for k in ref)
            assert batch["tokens"].dtype == torch.int32
            assert batch["loss_mask"].dtype == torch.float32
    finally:
        pre.close()
    assert not pre._t.is_alive()


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _jax_train_state(arch="llama3-8b", step=7):
    """JAX's own train state of the smoke model (bf16 params, f32 moments,
    an int32 step), its moments made nonzero."""
    model, opt = jax_build(jax_smoke(arch)), jax_optimizer("adamw")
    params = model.init(jax.random.PRNGKey(1))
    opt_state = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32) * p.astype(
        jnp.float32), opt.init(params))
    return JTrainState(params, opt_state, jnp.int32(step))


def _port_target(arch="llama3-8b"):
    model, opt = build_model(smoke_config(arch)), get_optimizer("adamw")
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    return TrainState(params, opt.init(params), 0)


def test_jax_directory_restores_bit_for_bit(tmp_path):
    js = _jax_train_state()
    JCheckpointManager(tmp_path).save(7, js)
    state, step = CheckpointManager(tmp_path).restore(None, _port_target())
    assert step == 7 and state.step == 7
    pairs = list(zip(tr.leaves_with_paths(state), jax.tree.leaves(js)))
    assert len(pairs) == len(jax.tree.leaves(js))
    assert any(t.dtype == torch.bfloat16 for (_, t), _ in pairs if isinstance(t, torch.Tensor))
    for (path, t), j in pairs:
        if path[-1] == "step":
            continue
        np.testing.assert_array_equal(bits_of(t), bits_of(j), err_msg=str(path))


_SHARDED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.checkpoint import CheckpointManager
mesh = jax.make_mesh((4, 2), ("data", "model"))
def put(a, spec):
    return jax.device_put(a, NamedSharding(mesh, spec))
tree = {"w": put(jnp.arange(8 * 6, dtype=jnp.float32).reshape(8, 6) / 7, PS("data", "model")),
        "b": put((jnp.arange(12, dtype=jnp.float32) / 3).astype(jnp.bfloat16), PS("data")),
        "r": put(jnp.arange(4 * 4, dtype=jnp.int32).reshape(4, 4), PS()),
        "step": jnp.int32(3)}
CheckpointManager(sys.argv[1]).save(3, tree)
"""


def test_sharded_jax_directory_restores(tmp_path):
    """Shards from 8 fake devices (one file each, replicas written once)
    assemble into the whole arrays."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SHARDED, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(list((tmp_path / "step_3").glob("w__*.npy"))) == 8
    target = {"w": torch.zeros(8, 6), "b": torch.zeros(12, dtype=torch.bfloat16),
              "r": torch.zeros(4, 4, dtype=torch.int32), "step": 0}
    got, step = CheckpointManager(tmp_path).restore(3, target)
    assert step == 3 and got["step"] == 3
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(48, dtype=np.float32).reshape(8, 6) / np.float32(7))
    want_b = (torch.arange(12, dtype=torch.float32) / 3).to(torch.bfloat16)
    assert torch.equal(got["b"], want_b) and got["b"].dtype == torch.bfloat16
    assert torch.equal(got["r"], torch.arange(16, dtype=torch.int32).reshape(4, 4))


def test_port_writes_jax_files(tmp_path):
    """The port's checkpoint of a state and JAX's of the same values are
    the same bytes, manifest included; JAX's manager restores the port's
    f32 / int32 leaves bit for bit and refuses its bf16 leaves exactly as
    it refuses its own (``No cast function available``: ROADMAP C)."""
    state = _port_target()
    state.step = 9
    CheckpointManager(tmp_path / "port").save(9, state)
    js = JTrainState(tr.map_leaves(_to_jax, state.params),
                     tr.map_leaves(_to_jax, state.opt_state), jnp.int32(9))
    JCheckpointManager(tmp_path / "jax").save(9, js)
    port_files = sorted(p.name for p in (tmp_path / "port" / "step_9").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "jax" / "step_9").iterdir())
    for name in port_files:
        a = (tmp_path / "port" / "step_9" / name).read_bytes()
        assert a == (tmp_path / "jax" / "step_9" / name).read_bytes(), name
    jmgr = JCheckpointManager(tmp_path / "port")
    f32_part = {"opt_state": js.opt_state, "step": js.step}
    got, step = jmgr.restore(9, f32_part)
    assert step == 9 and int(got["step"]) == 9
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(f32_part)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for directory in ("port", "jax"):
        with pytest.raises(ValueError, match="No cast function available"):
            JCheckpointManager(tmp_path / directory).restore(9, {"params": js.params})


def test_atomic_keep_async_latest(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(None, {"a": torch.zeros(2)})
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": {"i": 4}}
    for s in (1, 2, 3):
        mgr.save(s, {"a": tree["a"] + s, "n": {"i": s}})
    assert sorted(mgr.all_steps()) == [2, 3] and mgr.latest_step() == 3
    mgr.save_async(5, tree)
    mgr.wait()
    assert mgr.latest_step() == 5 and sorted(mgr.all_steps()) == [3, 5]
    got, step = mgr.restore(None, {"a": torch.zeros(2, 3), "n": {"i": 0}})
    assert step == 5 and torch.equal(got["a"], tree["a"]) and got["n"]["i"] == 4

    def crash(*args):  # a crash mid-save
        raise OSError("disk gone")

    monkeypatch.setattr(tmanager, "_save_npy", crash)
    with pytest.raises(OSError):
        mgr.save(6, tree)
    assert (tmp_path / "step_6.tmp").exists() and mgr.latest_step() == 5
    got, step = mgr.restore(None, {"a": torch.zeros(2, 3), "n": {"i": 0}})
    assert step == 5 and torch.equal(got["a"], tree["a"])
    monkeypatch.undo()
    mgr.save(6, tree)  # the stale .tmp is replaced
    assert not (tmp_path / "step_6.tmp").exists() and mgr.latest_step() == 6


def test_save_async_copies_before_returning(tmp_path, monkeypatch):
    """The tree changed in place after ``save_async`` returns (as the next
    train step changes params and moments) restores as it was at the call:
    the write thread is held until the change is made."""
    import threading

    gen = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn(4, 8, generator=gen).to(torch.bfloat16),
            "m": torch.randn(4, 8, generator=gen), "step": 7}
    want = {k: v.clone() for k, v in tree.items() if isinstance(v, torch.Tensor)}
    changed, write = threading.Event(), tmanager._save_npy

    def held_write(*args):
        assert changed.wait(30)
        write(*args)

    monkeypatch.setattr(tmanager, "_save_npy", held_write)
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(7, tree)
    tree["w"].add_(1.0)
    tree["m"].mul_(-3.0)
    changed.set()
    mgr.wait()
    got, step = mgr.restore(7, {"w": torch.zeros(4, 8, dtype=torch.bfloat16),
                                "m": torch.zeros(4, 8), "step": 0})
    assert step == 7 and got["step"] == 7
    assert torch.equal(got["w"], want["w"]) and torch.equal(got["m"], want["m"])


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

ARGV = ["--arch", "llama3-8b", "--smoke", "--steps", "6", "--batch", "8", "--seq", "32",
        "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]


def _equal_states(a: TrainState, b: TrainState) -> bool:
    la, lb = list(tr.leaves_with_paths(a)), list(tr.leaves_with_paths(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for (_, x), (_, y) in zip(la, lb))


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    state, records = launch_train.run(ARGV + ["--ckpt-dir", str(d)])
    return d, state, records


def test_launcher_runs_and_checkpoints(uninterrupted, tmp_path, capsys):
    d, state, records = uninterrupted
    assert state.step == 6 and [r.step for r in records] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r.loss) and np.isfinite(r.grad_norm) for r in records)
    assert sorted(CheckpointManager(d).all_steps()) == [2, 4, 6]
    launch_train.main(["--arch", "llama3-8b", "--smoke", "--steps", "4", "--batch", "8",
                       "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] done at step 4; final loss " in out


def test_injected_failure_rolls_back_and_ends_bit_for_bit(uninterrupted, tmp_path, capsys):
    """The fourth step (step index 3) fails once: the run restores step 2's
    checkpoint, restarts the data there and ends where the uninterrupted
    run ends, parameters and optimizer state bit for bit."""
    _, want, records = uninterrupted
    state, got = launch_train.run(ARGV + ["--ckpt-dir", str(tmp_path)], fail_step=3)
    out = capsys.readouterr().out
    assert "[train] step 3 failed (RuntimeError('injected failure at step 3'))" in out
    assert "[train] rolled back to step 2" in out
    assert [r.step for r in got] == [1, 2, 3, 3, 4, 5, 6]
    assert [r.loss for r in got][3:] == [r.loss for r in records][2:]
    assert _equal_states(state, want)


def test_resume_ends_bit_for_bit(uninterrupted, tmp_path, capsys):
    d, want, _ = uninterrupted
    (tmp_path / "step_4").mkdir()
    for f in (d / "step_4").iterdir():
        (tmp_path / "step_4" / f.name).write_bytes(f.read_bytes())
    state, records = launch_train.run(ARGV + ["--ckpt-dir", str(tmp_path), "--resume"])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert [r.step for r in records] == [5, 6]
    assert _equal_states(state, want)


def test_launcher_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 12"):
        launch_train.run(ARGV + ["--model-parallel", "2", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="injected failure at step 0"):
        launch_train.run(ARGV + ["--ckpt-dir", str(tmp_path)], fail_step=0)
