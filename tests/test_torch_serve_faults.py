"""The port's fault injection (``repro_torch.serve.faults``), background
compaction under the Engine, corrupt-checkpoint hardening and the
mutable-index checkpoint scenarios, against the JAX package's: the cases
of ``tests/test_faults.py`` that need neither the async pump nor a
sharded state, and the checkpoint cases of ``tests/test_mutate.py``.

Both packages get the same inputs: a seeded plan draws the same schedule
in each (the decision for an event is ``default_rng((seed, site, n,
extra))`` in both); engines are built from the same small-integer rows,
so their answers are compared with ids bitwise and distances equal; error
texts must equal the reference's with the file path replaced.  No test
waits on the clock: background compactions are joined with a timeout and
their result asserted.
"""

import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mutate as jx_mutate  # noqa: E402
from repro.ann import bruteforce as jx_bf  # noqa: E402
from repro.serve import Engine as JxEngine  # noqa: E402
from repro.serve import checkpoint as jx_ckpt  # noqa: E402
from repro.serve import faults as jx_faults  # noqa: E402
from repro_torch import mutate  # noqa: E402
from repro_torch.ann import bruteforce  # noqa: E402
from repro_torch.serve import (CheckpointError, CompactionError,  # noqa: E402
                               Engine, FaultPlan, PumpFault, ShardFault,
                               checkpoint, faults)

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts and ends with no installed plan, in either
    package."""
    for pkg in (faults, jx_faults):
        pkg.clear()
        pkg.clear_degraded()
    yield
    faults.clear()
    jx_faults.clear()


def _grid(rng, m, d):
    return rng.integers(-8, 8, size=(m, d)).astype(np.float32)


def assert_same(got, want):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


def same_error(port_exc, jx_exc, port_path, jx_path):
    def text(e, path):
        return str(e.value).replace(str(path), "<path>")
    assert type(port_exc.value).__name__ == type(jx_exc.value).__name__
    assert text(port_exc, port_path) == text(jx_exc, jx_path)


# ---------------------------------------------------------------- the plan

def test_fault_plan_deterministic_and_seed_sensitive():
    decisions = [FaultPlan(seed=7, shard_drop=0.3)._roll("shard_drop", n)
                 for n in range(50)]
    again = [FaultPlan(seed=7, shard_drop=0.3)._roll("shard_drop", n)
             for n in range(50)]
    other = [FaultPlan(seed=8, shard_drop=0.3)._roll("shard_drop", n)
             for n in range(50)]
    assert decisions == again
    assert decisions != other
    p = FaultPlan(seed=7)
    assert p._roll("shard_drop", 0, extra=1) != p._roll("shard_drop", 0,
                                                        extra=2)
    # the same draws as the reference, at every site
    jp = jx_faults.FaultPlan(seed=7)
    for site in faults.SITES:
        assert [p._roll(site, n, e) for n in range(20) for e in range(3)] \
            == [jp._roll(site, n, e) for n in range(20) for e in range(3)]
    assert faults.SITES == jx_faults.SITES


def _drive(pkg, plan, n_events=40):
    """Every hook of ``pkg`` driven ``n_events`` times under ``plan``, in
    one fixed order; returns what each call did."""
    out = []
    with pkg.injected(plan):
        for _ in range(n_events):
            for name, call in (
                    ("shard_events", lambda: pkg.shard_events(4)),
                    ("pump_tick", pkg.pump_tick),
                    ("compaction_attempt", pkg.compaction_attempt),
                    ("checkpoint_keep_bytes",
                     lambda: pkg.checkpoint_keep_bytes(1000))):
                try:
                    r = call()
                    out.append((name, None if r is None else
                                np.asarray(r).tolist()))
                except Exception as e:          # noqa: BLE001
                    out.append((name, type(e).__name__, str(e)))
    return out, {s: plan.events(s) for s in pkg.SITES}


@pytest.mark.parametrize("seed", [0, 11])
def test_fault_plan_event_sequences_match_reference(seed):
    """The same seed gives the same schedule: both packages' plans, driven
    through every hook in one order, make the same decisions (drop masks,
    raises with their texts, kept bytes) and count the same events."""
    kw = dict(seed=seed, shard_drop=0.3, shard_raise=0.2, slow_shard=0.3,
              slow_ms=0.0, pump_death=0.25, compact_fault=0.4,
              ckpt_truncate=0.5, truncate_frac=0.25,
              shard_drop_at=((1, 2),), pump_death_at=(3,),
              compact_fault_at=(5,), ckpt_truncate_at=(7,))
    got = _drive(faults, FaultPlan(**kw))
    want = _drive(jx_faults, jx_faults.FaultPlan(**kw))
    assert got == want
    kinds = {entry[1] for entry in got[0] if len(entry) == 3}
    assert kinds == {"ShardFault", "PumpFault", "CompactionError"}
    assert any(name == "shard_events" and r is not None
               for name, r, *_ in got[0])


def test_fault_plan_spec_and_validation():
    p = FaultPlan.from_spec("seed=7, shard_drop=0.1, slow_ms=5")
    assert p.seed == 7 and p.shard_drop == 0.1 and p.slow_ms == 5.0
    for bad, args in ((lambda m: m.FaultPlan.from_spec("shard_dorp=0.1"),
                       "unknown fault knob"),
                      (lambda m: m.FaultPlan.from_spec("seed"),
                       "bad --faults item"),
                      (lambda m: m.FaultPlan(shard_raise=1.5), "not a rate"),
                      (lambda m: m.FaultPlan(truncate_frac=0.0),
                       "truncate_frac")):
        with pytest.raises(ValueError, match=args) as e:
            bad(faults)
        with pytest.raises(ValueError) as je:
            bad(jx_faults)
        assert str(e.value) == str(je.value)
    assert "shard_drop=0.1" in FaultPlan(shard_drop=0.1).describe()
    spec = "seed=3,compact_fault=0.5,ckpt_truncate=0.25"
    assert (FaultPlan.from_spec(spec).describe()
            == jx_faults.FaultPlan.from_spec(spec).describe())


def test_injected_scoping_restores_previous_plan():
    outer = FaultPlan(seed=1)
    faults.install(outer)
    with faults.injected(FaultPlan(seed=2)) as inner:
        assert faults.active_plan() is inner
    assert faults.active_plan() is outer
    faults.clear()
    assert faults.active_plan() is None
    # hooks are no-ops with no plan
    assert faults.shard_events(4) is None
    faults.pump_tick()
    faults.compaction_attempt()
    assert faults.checkpoint_keep_bytes(100) is None
    assert jx_faults.active_plan() is None      # the packages do not share


def test_hooks_raise_the_typed_errors():
    """shard_raise / pump_death raise their types (ShardFault is
    transient; PumpFault is not a ServeError), and the degraded note is
    per thread, as in the reference."""
    from repro_torch.serve import ServeError, TransientFault

    with faults.injected(FaultPlan(shard_raise_at=(0,), pump_death_at=(0,))):
        with pytest.raises(ShardFault) as e:
            faults.shard_events(2)
        assert isinstance(e.value, TransientFault)
        with pytest.raises(PumpFault) as e:
            faults.pump_tick()
        assert not isinstance(e.value, ServeError)
    assert faults.last_degraded() is None
    faults.note_degraded(0.5, [1, 3])
    jx_faults.note_degraded(0.5, [1, 3])
    assert faults.last_degraded() == jx_faults.last_degraded() == (0.5,
                                                                   (1, 3))
    faults.clear_degraded()
    assert faults.last_degraded() is None


# ------------------------------------------------------ background compaction

def _mutable_engines(seed, n=200, d=16):
    """(X, port engine, reference engine) over MutableBruteForce of the
    same rows, each after the same insert and delete."""
    rng = np.random.default_rng(seed)
    X, new = _grid(rng, n, d), _grid(rng, 8, d)
    kw = dict(metric="euclidean", build_params={"delta_capacity": 32},
              k=5, batch_size=8)
    eng = Engine.build("MutableBruteForce", X, device="cpu", **kw)
    jeng = JxEngine.build("MutableBruteForce", X, **kw)
    for e in (eng, jeng):
        e.insert(new, auto_compact=False)
        e.delete(np.arange(0, 20, 3))
    return X, eng, jeng


def test_background_compaction_success_swaps_state():
    X, eng, jeng = _mutable_engines(8)
    want = eng.search(X[:4])
    assert_same(want, jeng.search(X[:4]))
    handle = eng.compact(background=True)
    assert handle.join(timeout=60).ok and handle.error is None
    assert eng.stats["compactions"] == 1
    assert int(eng.state["count"]) == 0            # delta folded in
    assert eng.state["count"].device.type == "cpu"
    assert_same(eng.search(X[:4]), want)           # same answers post-swap
    assert eng.join_compactions(timeout=1.0)
    assert eng._compactions == []                  # handle pruned
    assert jeng.compact(background=True).join(timeout=60).ok
    assert_same(eng.search(X[:4]), jeng.search(X[:4]))


def test_background_compaction_failure_leaves_serving_untouched():
    X, eng, jeng = _mutable_engines(9)
    state_before = eng.state
    want = eng.search(X[:4])
    with faults.injected(FaultPlan(compact_fault_at=(0,))):
        handle = eng.compact(background=True)
        handle.join(timeout=60)
    with jx_faults.injected(jx_faults.FaultPlan(compact_fault_at=(0,))):
        jhandle = jeng.compact(background=True)
        jhandle.join(timeout=60)
    assert handle.done() and not handle.ok
    assert isinstance(handle.error, CompactionError)
    assert str(handle.error) == str(jhandle.error)
    assert eng.state is state_before               # provably untouched
    assert eng.stats["compaction_failures"] == 1
    assert eng.stats["compactions"] == 0
    assert_same(eng.search(X[:4]), want)
    # and the NEXT compaction (event 1, not scheduled) succeeds
    done = []
    assert eng.compact(background=True, on_done=done.append).join(
        timeout=60).ok
    assert eng.stats["compactions"] == 1 and done == [None]
    assert_same(eng.search(X[:4]), want)


def test_foreground_compaction_failure_raises_and_counts():
    X, eng, jeng = _mutable_engines(10)
    state_before = eng.state
    with faults.injected(FaultPlan(compact_fault_at=(0,))):
        with pytest.raises(CompactionError,
                           match="serving state untouched") as e:
            eng.compact()
    with jx_faults.injected(jx_faults.FaultPlan(compact_fault_at=(0,))):
        with pytest.raises(jx_faults.CompactionError) as je:
            jeng.compact()
    assert str(e.value) == str(je.value)
    assert eng.state is state_before
    assert eng.stats["compaction_failures"] == 1


def test_background_compactions_race_serving():
    """Three background compactions (serialised on the mutation lock)
    race a serving loop with the interpreter switching threads every
    microsecond: every answer is the pre-compaction one (MutableBruteForce
    compaction keeps the live set and its ids), so a torn state swap would
    show, and every compaction lands."""
    X, eng, _ = _mutable_engines(11)
    want = eng.search(X[:16])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        handles = [eng.compact(background=True) for _ in range(3)]
        served = 0
        while not all(h.done() for h in handles) or served < 20:
            assert_same(eng.search(X[:16]), want)
            served += 1
            assert served < 100_000, "compactions never finished"
        for h in handles:
            assert h.join(timeout=60).ok
    finally:
        sys.setswitchinterval(old)
    assert eng.stats["compactions"] == 3
    assert eng.stats["compaction_failures"] == 0
    assert eng.join_compactions(timeout=60) and eng._compactions == []
    assert_same(eng.search(X[:16]), want)


def test_compact_itself_calls_the_fault_hook():
    """``mutate.compact`` calls ``faults.compaction_attempt()`` before the
    rebuild, as the reference's does: an injected fault raises from it,
    and the plan counts one compaction event per call."""
    rng = np.random.default_rng(12)
    st = mutate.BRUTEFORCE_SPEC.build(_grid(rng, 30, 8), metric="euclidean",
                                      delta_capacity=4, device="cpu")
    plan = FaultPlan(compact_fault_at=(1,))
    with faults.injected(plan):
        st = mutate.compact(st)
        with pytest.raises(CompactionError, match=r"\(event 1, seed 0\)"):
            mutate.compact(st)
    assert plan.events("compact_fault") == 2


def test_insert_auto_compacts_past_the_threshold():
    """An insert that fills the delta past ``compact_threshold`` compacts
    inline; with auto_compact=False a full delta raises DeltaFull."""
    rng = np.random.default_rng(13)
    X = _grid(rng, 40, 8)
    kw = dict(metric="euclidean", k=5, batch_size=8,
              build_params={"delta_capacity": 8, "compact_threshold": 0.5})
    eng = Engine.build("MutableBruteForce", X, device="cpu", **kw)
    jeng = JxEngine.build("MutableBruteForce", X, **kw)
    new = _grid(rng, 5, 8)
    np.testing.assert_array_equal(eng.insert(new), jeng.insert(new))
    assert eng.stats["compactions"] == jeng.stats["compactions"] == 1
    assert int(eng.state["count"]) == 0
    assert_same(eng.search(X[:6]), jeng.search(X[:6]))
    eng.insert(new[:4], auto_compact=False)
    with pytest.raises(mutate.DeltaFull):
        eng.insert(new, auto_compact=False)


# ------------------------------------------------------ checkpoint hardening

def _small_state(rng):
    return bruteforce.build(rng.standard_normal((80, 8)).astype(np.float32),
                            metric="euclidean", device="cpu")


def _pair_files(tmp_path, target, jx_target):
    path, jpath = tmp_path / "ck.npz", tmp_path / "jx_ck.npz"
    checkpoint.save(path, target)
    jx_ckpt.save(jpath, jx_target)
    assert path.stat().st_size == jpath.stat().st_size
    return path, jpath


def _jx_copy(state):
    """The reference's copy of a port BruteForce state (its arrays)."""
    import jax.numpy as jnp
    from repro.ann.functional import IndexState

    return IndexState(state.algo, state.metric,
                      {k: jnp.asarray(v.numpy())
                       for k, v in state.arrays.items()}, state.static)


def test_truncated_checkpoint_raises_typed(tmp_path):
    st = _small_state(np.random.default_rng(13))
    path, jpath = _pair_files(tmp_path, st, _jx_copy(st))
    blob, jblob = path.read_bytes(), jpath.read_bytes()
    for frac in (0.1, 0.5, 0.9, 0.999):
        path.write_bytes(blob[:int(len(blob) * frac)])
        jpath.write_bytes(jblob[:int(len(jblob) * frac)])
        with pytest.raises(CheckpointError, match="truncated or bit-flip") \
                as e:
            checkpoint.load(path, device="cpu")
        assert path.name in str(e.value)     # names the file and its size
        with pytest.raises(jx_ckpt.CheckpointError) as je:
            jx_ckpt.load(jpath)
        same_error(e, je, path, jpath)


def test_bitflipped_checkpoint_raises_typed(tmp_path):
    """A flipped byte mid-archive either raises CheckpointError, with the
    reference's text, or loads, as in the reference -- never a raw
    traceback."""
    st = _small_state(np.random.default_rng(14))
    path, jpath = _pair_files(tmp_path, st, _jx_copy(st))
    for p in (path, jpath):
        blob = bytearray(p.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        p.write_bytes(bytes(blob))
    try:
        checkpoint.load(path, device="cpu")
        got = None
    except CheckpointError as e:
        got = str(e).replace(str(path), "<path>")
    try:
        jx_ckpt.load(jpath)
        want = None
    except jx_ckpt.CheckpointError as e:
        want = str(e).replace(str(jpath), "<path>")
    assert got == want


def test_truncated_archive_member_raises_typed(tmp_path):
    rng = np.random.default_rng(15)
    a, b = _small_state(rng), _small_state(rng)
    path, jpath = _pair_files(tmp_path, {"a": a, "b": b},
                              {"a": _jx_copy(a), "b": _jx_copy(b)})
    outs = []
    for p in (path, jpath):
        out = p.with_name("cut_" + p.name)
        with zipfile.ZipFile(p) as zin, \
                zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as zout:
            for info in zin.infolist():
                data = zin.read(info.filename)
                if info.filename.endswith("0.npz"):
                    data = data[:len(data) // 2]
                zout.writestr(info.filename, data)
        outs.append(out)
    with pytest.raises(CheckpointError, match="bytes on disk") as e:
        checkpoint.load(outs[0], device="cpu")
    with pytest.raises(jx_ckpt.CheckpointError) as je:
        jx_ckpt.load(outs[1])
    same_error(e, je, outs[0], outs[1])


def test_injected_truncation_roundtrip(tmp_path):
    state = _small_state(np.random.default_rng(16))
    good, bad = tmp_path / "good.npz", tmp_path / "bad.npz"
    # event 0 truncates, event 1 saves intact
    with faults.injected(FaultPlan(ckpt_truncate_at=(0,),
                                   truncate_frac=0.4)) as plan:
        checkpoint.save(bad, state)
        checkpoint.save(good, state)
    assert plan.events("ckpt_truncate") == 2
    assert bad.stat().st_size == int(good.stat().st_size * 0.4)
    assert not bad.with_suffix(".npz.tmp").exists()
    with pytest.raises(CheckpointError, match="truncated or bit-flip"):
        checkpoint.load(bad, device="cpu")
    with pytest.raises(jx_ckpt.CheckpointError, match="truncated or bit-"):
        jx_ckpt.load(bad)
    restored, _ = checkpoint.load(good, device="cpu").only
    assert torch.equal(restored["X"], state["X"])


# ------------------------------------------ mutable checkpoints (test_mutate)

def _mutated_state(pkg, rng, **build):
    X = _grid(rng, 25, 8)
    st = pkg.BRUTEFORCE_SPEC.build(X, metric="euclidean", delta_capacity=8,
                                   **build)
    st, _ = pkg.insert(st, _grid(rng, 4, 8))
    return pkg.delete(st, [1, 26])


def test_checkpoint_v4_roundtrips_delta_and_tombstones(tmp_path):
    rng = np.random.default_rng(15)
    st = _mutated_state(mutate, rng, device="cpu")
    Q = _grid(rng, 5, 8)
    d0, i0 = mutate.BRUTEFORCE_SPEC.search(st, Q, k=8)
    path = tmp_path / "mut.ckpt"
    checkpoint.save(path, st, extra={"k": 8})
    st2, extra = checkpoint.load(path, device="cpu").only
    assert extra == {"k": 8}
    assert int(st2["count"]) == 4 and int(st2["next_id"]) == 29
    gids_a, rows_a = mutate.live_items(st)
    gids_b, rows_b = mutate.live_items(st2)
    np.testing.assert_array_equal(gids_a, gids_b)
    np.testing.assert_array_equal(rows_a, rows_b)
    d1, i1 = mutate.BRUTEFORCE_SPEC.search(st2, Q, k=8)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    # the reference reads the port's v4 file: same live set, same answers
    jst, jextra = jx_ckpt.load(path).only
    assert jextra == {"k": 8}
    np.testing.assert_array_equal(jx_mutate.live_items(jst)[0], gids_a)
    _, ji = jx_mutate.BRUTEFORCE_SPEC.search(jst, Q, k=8)
    np.testing.assert_array_equal(np.asarray(ji), i0.numpy())


def test_v3_checkpoint_of_mutated_index_rejected(tmp_path, monkeypatch):
    """A mutated index persisted by a pre-mutation build refuses to load,
    with the distinct v3 explanation, in the reference's words."""
    rng = np.random.default_rng(16)
    st = _mutated_state(mutate, rng, device="cpu")
    jst = _mutated_state(jx_mutate, np.random.default_rng(16))
    path, jpath = tmp_path / "old.ckpt", tmp_path / "jx_old.ckpt"
    monkeypatch.setattr(checkpoint, "CHECKPOINT_VERSION", 3)
    monkeypatch.setattr(jx_ckpt, "CHECKPOINT_VERSION", 3)
    checkpoint.save(path, st)
    jx_ckpt.save(jpath, jst)
    monkeypatch.undo()
    with pytest.raises(CheckpointError,
                       match=r"version 3.*version 4.*pre-dates streaming "
                             r"mutation.*deleted rows resurrected") as e:
        checkpoint.load(path, device="cpu")
    with pytest.raises(jx_ckpt.CheckpointError) as je:
        jx_ckpt.load(jpath)
    same_error(e, je, path, jpath)


CRASH_CHILD = """
import os
from repro_torch import mutate
from repro_torch.mutate import delta
from repro_torch.serve import checkpoint

state, _ = checkpoint.load({path!r}, device="cpu").only

def die(*args, **kwargs):
    os._exit({code})

delta._inner_build = die
mutate.compact(state)
raise AssertionError("compact() returned without hitting _inner_build")
"""


def test_crash_mid_compaction_recovers_pre_compaction_state(tmp_path):
    """Kill a child at the worst moment of the port's compact() -- after
    the live-set gather, before the rebuilt state exists -- then reload
    the v4 checkpoint: it still serves the pre-compaction live set
    exactly, in the port and in the reference."""
    rng = np.random.default_rng(17)
    st = _mutated_state(mutate, rng, device="cpu")
    Q = _grid(rng, 6, 8)
    want_d, want_i = mutate.BRUTEFORCE_SPEC.search(st, Q, k=10)
    path = tmp_path / "churn.ckpt"
    checkpoint.save(path, st)
    ref_bytes = path.read_bytes()

    out = subprocess.run(
        [sys.executable, "-c", CRASH_CHILD.format(path=str(path), code=7)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 7, (out.returncode, out.stderr[-2000:])

    assert path.read_bytes() == ref_bytes     # nothing half-written
    st2, _ = checkpoint.load(path, device="cpu").only
    got_d, got_i = mutate.BRUTEFORCE_SPEC.search(st2, Q, k=10)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    # and the recovered state is fully live: compaction works post-crash
    st3 = mutate.compact(st2)
    d3, i3 = mutate.BRUTEFORCE_SPEC.search(st3, Q, k=10)
    assert torch.equal(i3, want_i) and torch.equal(d3, want_d)
    jst, _ = jx_ckpt.load(path).only
    _, ji = jx_mutate.BRUTEFORCE_SPEC.search(jst, Q, k=10)
    np.testing.assert_array_equal(np.asarray(ji), want_i.numpy())


def test_reference_bruteforce_state_loads_equal(tmp_path):
    """A reference BruteForce file gives the port the same tensors."""
    X = np.random.default_rng(18).standard_normal((50, 8)).astype(np.float32)
    path = tmp_path / "bf.ckpt"
    jx_ckpt.save(path, jx_bf.build(X, metric="euclidean"))
    st, _ = checkpoint.load(path, device="cpu").only
    want = bruteforce.build(X, metric="euclidean", device="cpu")
    assert st.static == want.static and sorted(st.arrays) == ["X", "xsq"]
    assert torch.equal(st["X"], want["X"])
