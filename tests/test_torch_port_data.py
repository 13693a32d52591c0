"""The port's data path against its plain version and the JAX package's, on
the CPU: the native motion-feature library (``data/native.py``, built with
g++ into the port's build directory) against the port's numpy pipeline and
JAX's numpy functions; the fused pair call against the per-stage route;
dataset items on the native route against the numpy route; the build (a
failed one raises with the compiler's output, racing builds give one
library); the loader's workers (batch for batch equal to one worker, a
worker's exception raised in the consumer, an abandoned epoch stopping its
threads, ``set_epoch`` replay); and the skeleton and the three feature
helpers against JAX.  JAX's own native library is monkeypatched off
(``mixermdm_tpu.data.native.get_lib``) wherever JAX code could reach it, so
nothing builds into the root ``csrc/``.

Tolerances are those of tests/test_native.py (the JAX package's native
library against its numpy path: features 2e-5, root quaternion and
position 1e-5, the pair's person 1 at 1e-6 and person 2 at 1e-5 of the
per-stage route, dataset items 2e-5 / 2e-4): the C++ computes in float64
from float32 inputs, the numpy path in float64 from the same inputs, and
the two round the float32 outputs after sums in another order.  The
skeleton and the feature helpers are numpy copies: 1e-12 (float64), and
``get_root_pos`` at 1e-5 (float32 axis-angle in torch against jnp).  No
rate is asserted: CPU rates are unsteady.
"""

import os
import random
import re
import threading
import time

import numpy as np
import pytest
import torch

FEAT_TOL = dict(atol=2e-5, rtol=0)
ROOT_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny; one intra-op thread per test worker keeps the
    port's tests from oversubscribing the cores the other workers share."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_jax_native(monkeypatch):
    import mixermdm_tpu.data.native as jnative

    monkeypatch.setattr(jnative, "get_lib", lambda: None)


def raw_motion(T=30, seed=0):
    """Reduced-layout motion (22*3 positions + 21*6 rotations), as the
    dataset's ``load_raw_motion`` gives it."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((T, 22, 3)).astype(np.float32) * 0.1
    pos[..., 1] += 1.0
    rot = rng.standard_normal((T, 21 * 6)).astype(np.float32)
    return np.concatenate([pos.reshape(T, -1), rot], axis=1)


# ------------------------------------------------------------- the library

@pytest.mark.parametrize("prev_frames,flip", [(0, True), (3, True), (0, False)])
def test_native_matches_numpy_and_jax(prev_frames, flip):
    from mixermdm_tpu.utils.features import process_motion_interhuman as j_process
    from mixermdm_tpu_torch.data import native
    from mixermdm_tpu_torch.utils.features import process_motion_interhuman

    m = raw_motion(seed=prev_frames)
    feats, quat, pos = native.process_motion_interhuman_native(m, 0.001, prev_frames, flip)
    assert feats.shape == (29, 262) and feats.dtype == np.float32
    assert set(np.unique(feats[:, 258:])) <= {0.0, 1.0}
    for fn in (process_motion_interhuman, j_process):
        f, q, p = fn(m.astype(np.float64), 0.001, prev_frames, 22, flip)
        np.testing.assert_allclose(feats, f, **FEAT_TOL)
        np.testing.assert_allclose(np.abs(quat), np.abs(q), **ROOT_TOL)
        np.testing.assert_allclose(pos, p, **ROOT_TOL)


def test_native_validates_its_inputs():
    from mixermdm_tpu_torch.data import native

    with pytest.raises(ValueError, match="motion must be"):
        native.process_motion_interhuman_native(raw_motion()[:, :100], 0.001, 0)
    with pytest.raises(ValueError, match="prev_frames"):
        native.process_motion_interhuman_native(raw_motion(T=5), 0.001, 5)


def test_pair_call_matches_per_stage_and_numpy_routes():
    """The fused pair call against the native per-stage route and the numpy
    route (``process_pair`` inside ``ops.plain_versions()``); where it does
    not take the clips (lengths that differ) it says so and the dataset's
    route falls to the per-stage call."""
    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.data import interhuman, native

    m1, m2 = raw_motion(T=40, seed=4), raw_motion(T=40, seed=5)
    o1, o2, n = native.process_pair_interhuman_native(m1, m2, 0.001, 0, 50)
    assert (o1.shape, o2.shape, n) == ((50, 262), (50, 262), 39)
    assert not o1[39:].any() and not o2[39:].any()
    stage = interhuman._relative_and_pad(*native.process_motion_interhuman_native(m1, 0.001, 0),
                                         *native.process_motion_interhuman_native(m2, 0.001, 0),
                                         50)
    np.testing.assert_allclose(o1, stage[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(o2, stage[1], atol=1e-5, rtol=0)
    with ops.plain_versions():
        p1, p2, pn = interhuman.process_pair(m1, m2, 50)
    assert pn == n
    np.testing.assert_allclose(o1, p1, atol=2e-5, rtol=0)
    np.testing.assert_allclose(o2, p2, atol=2e-4, rtol=0)
    assert native.process_pair_interhuman_native(m1, m2[:-1], 0.001, 0, 50) is None
    before = dict(native.calls)
    q1, q2, qn = interhuman.process_pair(m1, m2[:-1], 50)
    assert qn == 39 and native.calls["process_motion_interhuman"] == \
        before.get("process_motion_interhuman", 0) + 2


def test_argtypes_match_the_source():
    """Each bound function's parameter count and its ``int64_t`` positions
    against the ``extern "C"`` signature in the source."""
    from mixermdm_tpu_torch.data import native

    with open(native.SOURCE) as f:
        src = f.read()
    for name, argtypes in native.ARGTYPES.items():
        m = re.search(r"int " + name + r"\(([^)]*)\)", src)
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), name
        for p, a in zip(params, argtypes):
            if p.startswith("int64_t"):
                assert a is native.ctypes.c_int64, (name, p)


def test_build_failure_raises_and_builds_race(tmp_path, monkeypatch):
    """A source the compiler refuses raises with its output (nothing falls
    back to numpy, and the dataset's route raises too); four threads
    building the same source at once into an empty build directory get one
    library."""
    from mixermdm_tpu_torch.data import interhuman, native
    from mixermdm_tpu_torch.ops import _lib

    assert "motion_ops.cpp" not in _lib.SOURCES + _lib.HEADERS
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build(str(tmp_path / "build"))[0])
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and len(set(paths)) == 1 and os.path.isfile(paths[0])
    assert os.listdir(tmp_path / "build") == [os.path.basename(os.path.dirname(paths[0]))]

    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "_lib_handle", None)
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build(str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed"):
        interhuman.process_pair(raw_motion(seed=1), raw_motion(seed=2), 40)


# ------------------------------------------------------------- the dataset

@pytest.fixture(scope="module")
def ih_root(tmp_path_factory):
    from mixermdm_tpu_torch.data.synthetic import make_interhuman_fixture

    root = str(tmp_path_factory.mktemp("ih"))
    make_interhuman_fixture(root, n_clips=4, n_frames=[40, 70, 33, 55])
    return root


def test_dataset_items_native_against_numpy(ih_root):
    """Items of the default (native) route against the numpy route, the same
    augmentation draws; the native library called once an item (the pair
    call), the numpy route calling it never."""
    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.data import native
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset

    nat = InterHumanDataset(ih_root, mode="train", max_gt_length=32, rng=random.Random(7))
    ref = InterHumanDataset(ih_root, mode="train", max_gt_length=32, rng=random.Random(7))
    before = native.calls["process_pair_interhuman"]
    items = [nat[i] for i in range(len(nat))]
    assert native.calls["process_pair_interhuman"] == before + len(nat)
    with ops.plain_versions():
        plain = [ref[i] for i in range(len(ref))]
    assert native.calls["process_pair_interhuman"] == before + len(nat)
    for a, b in zip(items, plain):
        assert a["motion_lens"] == b["motion_lens"] and a["text"] == b["text"]
        np.testing.assert_allclose(a["motion1"], b["motion1"], atol=2e-5, rtol=0)
        np.testing.assert_allclose(a["motion2"], b["motion2"], atol=2e-4, rtol=0)


# -------------------------------------------------------------- the loader

class _Items:
    """A dataset whose items are a pure function of the index."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"name": f"item{i}", "motion1": np.full((4, 3), i, np.float32), "motion_lens": i}


def _consume(loader, timeout=30.0):
    """The loader's batches, or the exception it raised, from another
    thread joined within ``timeout``; fails on a hang."""
    out = {}

    def run():
        try:
            out["batches"] = list(loader)
        except Exception as e:  # noqa: BLE001 - returned to the caller
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "the loader hung"
    return out


@pytest.mark.parametrize("workers", [2, 4])
def test_workers_deliver_in_index_order(workers, ih_root):
    """N workers (more than the cores, the switch interval shortened)
    against one: the same batches, batch for batch, in index order, with
    ``drop_last`` off (the last batch partial) and shuffled; the InterHuman
    set's names in the same order."""
    import sys

    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import DataLoader

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for epoch in range(2):
            one = DataLoader(_Items(), 4, drop_last=False, seed=5, num_workers=1, prefetch=1)
            many = DataLoader(_Items(), 4, drop_last=False, seed=5, num_workers=workers * 4,
                              prefetch=2)
            one.set_epoch(epoch)
            many.set_epoch(epoch)
            a, b = _consume(one)["batches"], _consume(many)["batches"]
            assert len(a) == len(b) == 6 and len(a[-1]["name"]) == 3
            for x, y in zip(a, b):
                assert x["name"] == y["name"]
                np.testing.assert_array_equal(x["motions"], y["motions"])
        ds = InterHumanDataset(ih_root, mode="train", max_gt_length=32)
        names1 = [b["name"] for b in DataLoader(ds, 2, seed=7)]
        names4 = [b["name"] for b in DataLoader(ds, 2, seed=7, num_workers=workers)]
        assert names1 == names4 and len(names1) == len(ds) // 2
    finally:
        sys.setswitchinterval(prev)


def test_unshuffled_order():
    from mixermdm_tpu_torch.data.loader import DataLoader

    batches = list(DataLoader(_Items(10), 4, shuffle=False))
    assert [b["motion_lens"].tolist() for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("workers", [1, 4])
def test_worker_exception_reaches_the_consumer(workers):
    """A transform that raises on the second batch: the consumer gets the
    error within the time limit, not a hang."""
    from mixermdm_tpu_torch.data.loader import DataLoader

    calls = {"n": 0}
    lock = threading.Lock()

    def bad_transform(batch):
        with lock:
            calls["n"] += 1
            if calls["n"] >= 2:
                raise RuntimeError("corrupt sample")
        return batch

    out = _consume(DataLoader(_Items(), 2, seed=7, num_workers=workers, prefetch=1,
                              transform=bad_transform))
    assert isinstance(out.get("error"), RuntimeError) and "corrupt sample" in str(out["error"])


def test_abandoned_epoch_stops_its_workers():
    from mixermdm_tpu_torch.data.loader import DataLoader

    before = threading.active_count()
    it = iter(DataLoader(_Items(40), 2, num_workers=4, prefetch=1))
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_set_epoch_replays_with_one_worker(ih_root):
    """With ``reseed_dataset`` a new loader set to epoch 2 replays the third
    epoch of one that iterated there: items, motions and texts."""
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import DataLoader

    def make():
        return DataLoader(InterHumanDataset(ih_root, mode="train", max_gt_length=32),
                          batch_size=2, seed=3, reseed_dataset=True)

    first = make()
    epochs = [list(first) for _ in range(3)]
    again = make()
    again.set_epoch(2)
    for a, b in zip(epochs[2], list(again)):
        assert a["name"] == b["name"] and a["text"] == b["text"]
        np.testing.assert_array_equal(a["motions"], b["motions"])


# ---------------------------------------------- skeleton and the helpers

def _joints(T=12, seed=0):
    rng = np.random.default_rng(seed)
    j = rng.standard_normal((T, 22, 3)) * 0.3
    j[..., 1] += 1.0
    return j


def test_skeleton_matches_jax():
    """Offsets from a pose, IK (also with the forward direction smoothed),
    FK with and without the root rotation; FK(IK) rebuilds the joints'
    bone directions on the pose's own offsets."""
    from mixermdm_tpu.utils.skeleton import Skeleton as J
    from mixermdm_tpu_torch.utils.skeleton import Skeleton

    joints = _joints()
    got, want = Skeleton(), J()
    assert got.parents == want.parents
    np.testing.assert_allclose(got.offsets_from_joints(joints[0]),
                               want.offsets_from_joints(joints[0]), atol=1e-12, rtol=0)
    for smooth in (False, True):
        q = got.inverse_kinematics(joints, smooth_forward=smooth)
        np.testing.assert_allclose(q, want.inverse_kinematics(joints, smooth_forward=smooth),
                                   atol=1e-12, rtol=0)
    for root_rot in (True, False):
        np.testing.assert_allclose(
            got.forward_kinematics(q, joints[:, 0], root_rot),
            want.forward_kinematics(q, joints[:, 0], root_rot), atol=1e-12, rtol=0)
    q = got.inverse_kinematics(joints)
    fk = got.forward_kinematics(q, joints[:, 0])
    np.testing.assert_allclose(fk[0], joints[0], atol=1e-6)
    with pytest.raises(ValueError):
        Skeleton().forward_kinematics(q, joints[:, 0])


def test_uniform_skeleton_matches_jax(tmp_path):
    from mixermdm_tpu.utils.skeleton import Skeleton as J
    from mixermdm_tpu.utils.skeleton import uniform_skeleton as j_uniform
    from mixermdm_tpu_torch.utils.skeleton import uniform_skeleton

    src, tgt = _joints(seed=1), _joints(T=2, seed=2)
    np.save(tmp_path / "tgt.npy", tgt.reshape(2, -1))
    offsets = J().offsets_from_joints(tgt[0])
    np.testing.assert_allclose(uniform_skeleton(src, target_offsets=offsets),
                               j_uniform(src, target_offsets=offsets), atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        uniform_skeleton(src, target_skeleton_path=str(tmp_path / "tgt.npy")),
        j_uniform(src, target_skeleton_path=str(tmp_path / "tgt.npy")), atol=1e-12, rtol=0)
    with pytest.raises(ValueError):
        uniform_skeleton(src)


def test_feature_helpers_match_jax(tmp_path):
    """``load_motion_hml3d`` on files it reads (and too short a clip, and a
    missing file), ``extract_smpl``, ``get_root_pos``."""
    from mixermdm_tpu.utils import features as J
    from mixermdm_tpu_torch.utils import features as P

    rng = np.random.default_rng(3)
    np.save(tmp_path / "pos.npy", rng.standard_normal((20, 24, 3)).astype(np.float32))
    np.save(tmp_path / "rot.npy", rng.standard_normal((19, 263)).astype(np.float32))
    args = (str(tmp_path / "pos.npy"), str(tmp_path / "rot.npy"))
    got, want = P.load_motion_hml3d(*args, 10), J.load_motion_hml3d(*args, 10)
    assert got[1] is None and want[1] is None and got[0].shape == (19, 192)
    np.testing.assert_array_equal(got[0], want[0])
    assert P.load_motion_hml3d(*args, 30) == (None, None)
    assert P.load_motion_hml3d(str(tmp_path / "none.npy"), args[1], 10) == (None, None)

    motion = rng.standard_normal((9, 22 * 6 + 23 * 3)).astype(np.float32)
    for g, w in zip(P.extract_smpl(motion), J.extract_smpl(motion)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    joints = _joints(seed=4).astype(np.float32)
    got = P.get_root_pos(joints)
    assert got.shape == (12, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, J.get_root_pos(joints), atol=1e-5, rtol=0)


# ------------------------------------------- the card's phases, rehearsed

def test_chip_smoke_phases_5e_5f_run_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phases 5e and 5f at the tiny config on the CPU
    (the plain versions on both sides of each kernels-vs-plain check): the
    step checks, the five chains and their float64 replays, the host
    library against numpy, the rates printed (not asserted)."""
    import chip_smoke

    counts, engine = chip_smoke.engine_phase(0, "cpu", device="cpu", tiny=True)
    assert not counts and len(engine["chains"]) == 5
    for label, chain in engine["chains"].items():
        assert chain["model_calls"] == 5, label
        assert all(g <= chip_smoke.REPLAY_TOL for g, _ in chain["replay_gaps"].values()), label
    data = chip_smoke.data_phase(0, "cpu", str(tmp_path), clips=40)
    assert max(data["native_vs_numpy"]) <= 2e-4
    assert set(data["items_per_s"]) == {"dataset numpy", "dataset native",
                                        "loader B 64, 1 workers", "loader B 64, 4 workers",
                                        "loader B 64, 8 workers"}
