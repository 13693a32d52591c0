"""The port's evaluation protocol against the JAX package's, on the CPU in
float32: one whole dataset side (``run_side``) for both evaluator wrappers
with a stub generator that returns fixed motions, so that the whole metrics
dict (MM-Distance, R-precision, FID, Diversity, MultiModality over two
replications) is compared; ``calculate_f_score`` on those dicts; the
DualMDM cross sweep; and the ground-truth side's datasets: the port's
``InterHumanDataset`` (train and test) and ``HumanML3DDataset`` (plain and
``extended``) item for item against the JAX package's on the synthetic
fixtures, with the same ``random.Random`` seed.

The stub's motion for an item is a function of its text and its place in
the batch, so both packages score the same motions: every difference comes
from the evaluators (the InterCLIP pair of tests/test_torch_port_eval.py,
the same weights through ``weights.py``) and the centring chain.
Tolerances: 1e-4 relative (1e-5 absolute) for the metrics, which are
distances and FIDs of those embeddings; the datasets' items 1e-5 (the same
numpy arithmetic, float32); texts and lengths exactly.
"""

import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_eval import interclip_pair

METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
T = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def stub_motions(texts, n_frames, width):
    """(B, n_frames, width) motions, item j a function of (texts[j], j)."""
    out = []
    for j, text in enumerate(texts):
        rng = np.random.default_rng(zlib.crc32(text.encode()) + 7919 * j)
        m = rng.standard_normal((n_frames, width)).astype(np.float32) * 0.3
        for p in range(width // 262):
            m[:, 262 * p + 132:262 * p + 258] += np.tile(
                np.asarray([1, 0, 0, 1, 0, 0], np.float32), 21)
        out.append(m)
    return np.stack(out)


class PortStub:
    """The port's system contract, returning :func:`stub_motions`; records
    every ``sample`` call's keyword arguments and generator seed."""

    device = torch.device("cpu")
    force_influence_val = None

    def __init__(self, width=524):
        self.width, self.calls = width, []

    def generate_cond(self, batch):
        return list(batch["text"])

    def sample(self, cond, n_frames, generator=None, **kwargs):
        self.calls.append((generator.initial_seed(), kwargs))
        return torch.from_numpy(stub_motions(cond, n_frames, self.width))


class JaxStub:
    """The JAX system contract (``params``, ``rng``), the same motions."""

    def __init__(self, width=524):
        self.width = width

    def generate_cond(self, params, batch):
        return list(batch["text"])

    def sample(self, params, cond, n_frames, rng, **kwargs):
        return jnp.asarray(stub_motions(cond, n_frames, self.width))


class FakeGT:
    """A ground-truth set of dict items, two persons each, lengths that
    differ inside a batch (tests/test_eval_datasets.py's ``_FakeGT``)."""

    def __init__(self, n=6):
        rng = np.random.default_rng(0)
        self.items = [{"name": f"c{i}", "text": f"interaction number {i}",
                       "motion1": stub_motions([f"gt a {i}"], T, 262)[0],
                       "motion2": stub_motions([f"gt b {i}"], T, 262)[0],
                       "motion_lens": T - int(rng.integers(0, 5)),
                       "text_individual1": f"first person {i}",
                       "text_individual2": f"second person {i}"} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


SIDE = dict(num_samples=6, batch_size=4, max_frames=T, replications=2, seed=3,
            mm_num_samples=2, mm_num_repeats=3)


@pytest.fixture(scope="module")
def sides():
    """run_side of both packages on both wrappers: {wrapper: (port, jax)}."""
    from mixermdm_tpu.eval import EvalProtocol as JProtocol
    from mixermdm_tpu.eval import EvaluatorWrapper as JW, EvaluatorWrapperIndividual as JWI
    from mixermdm_tpu.eval.driver import run_side as j_run_side
    from mixermdm_tpu_torch.eval import EvalProtocol, EvaluatorWrapper, \
        EvaluatorWrapperIndividual
    from mixermdm_tpu_torch.eval.driver import run_side

    out = {}
    for kind, mode, jw, tw in (("interaction", "interaction", JW, EvaluatorWrapper),
                               ("individual", "individual", JWI, EvaluatorWrapperIndividual)):
        jm, params, tm = interclip_pair(mode, seed=40)
        individual = kind == "individual"
        got = run_side(PortStub(), FakeGT(), tw(tm), EvalProtocol(), individual=individual,
                       **SIDE)
        want = j_run_side(JaxStub(), None, FakeGT(), jw(jm, params), JProtocol(),
                          individual=individual, **SIDE)
        out[kind] = (got, want)
    return out


@pytest.mark.parametrize("kind", ["interaction", "individual"])
def test_run_side_metrics_match_jax(sides, kind):
    """The whole metrics dict of one side, every metric, name and
    replication."""
    got, want = sides[kind]
    assert list(got) == list(want)
    for metric in want:
        assert list(got[metric]) == list(want[metric]), metric
        for name in want[metric]:
            np.testing.assert_allclose(got[metric][name], want[metric][name],
                                       err_msg=f"{metric} / {name}", **METRIC_TOL)
    assert len(got["FID"]["mixermdm"]) == 2 and got["MultiModality"]["mixermdm"][0] > 0


def test_f_score_and_summary_match_jax(sides):
    from mixermdm_tpu.eval import calculate_f_score as j_f
    from mixermdm_tpu.eval.driver import summarize_metrics as j_sum
    from mixermdm_tpu_torch.eval import calculate_f_score
    from mixermdm_tpu_torch.eval.driver import clean_json, summarize_metrics

    (g_ih, w_ih), (g_h, w_h) = sides["interaction"], sides["individual"]
    got, want = calculate_f_score(g_ih, g_h, 2), j_f(w_ih, w_h, 2)
    for metric in want:
        for name in want[metric]:
            np.testing.assert_allclose(np.asarray(got[metric][name], np.float64),
                                       np.asarray(want[metric][name], np.float64),
                                       err_msg=f"{metric} / {name}", **METRIC_TOL)
    s_got, s_want = clean_json(summarize_metrics(g_ih, 2)), clean_json(j_sum(w_ih, 2))
    assert s_got.keys() == s_want.keys()
    np.testing.assert_allclose(s_got["FID"]["mixermdm"], s_want["FID"]["mixermdm"],
                               **METRIC_TOL)
    # the 0/0 limit of the harmonic mean is 0
    zero = {"Diversity": {"m": [0.0, 0.0]}}
    assert calculate_f_score(zero, zero)["Diversity"]["m"][0] == 0.0


def test_generation_draws_per_replication_batch_and_stream(sides):
    """Each batch draws from a generator seeded by (seed + 1000 replication,
    batch, stream): the two replications and the MultiModality sets do not
    share a draw; a run replays with the same seeds."""
    from mixermdm_tpu_torch.eval import EvalProtocol
    from mixermdm_tpu_torch.eval.datasets import batch_generator
    from mixermdm_tpu_torch.eval.driver import run_side

    stub = PortStub()

    class Nil:
        def get_co_embeddings(self, texts, motions, lens):
            return np.eye(len(texts), 4), np.eye(len(texts), 4)

        def get_motion_embeddings(self, motions, lens):
            return np.random.default_rng(len(motions)).standard_normal((len(motions), 4))

    run_side(stub, FakeGT(), Nil(), EvalProtocol(), individual=False, **SIDE)
    seeds = [s for s, _ in stub.calls]
    assert len(seeds) == len(set(seeds)) == 2 * (2 + 2)  # 2 reps x (2 batches + 2 MM sets)
    assert seeds[0] == batch_generator(3, 0, 0, "cpu").initial_seed()
    assert seeds[4] == batch_generator(3 + 1000, 0, 0, "cpu").initial_seed()
    assert seeds[2] == batch_generator(3, 0, 1, "cpu").initial_seed()


def test_dualmdm_cross_sweeps_as_arguments():
    """run_dualmdm_cross: each sweep value reaches ``sample`` as an argument
    (None as no argument), the system's own ``force_influence_val`` stays as
    it was, every value draws the same noise, and the individual texts come
    from the HumanML3D side; the metrics dict names each value."""
    from mixermdm_tpu_torch.eval import EvalProtocol
    from mixermdm_tpu_torch.eval.driver import run_dualmdm_cross

    texts = []

    class Stub(PortStub):
        force_influence_val = 0.7

        def generate_cond(self, batch):
            texts.append((list(batch["text_individual1"]), list(batch["text_individual2"])))
            return super().generate_cond(batch)

    class Hml:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return {"text": f"hml text {i}"}

    class Wrap:
        def get_co_embeddings(self, t, m, lens):
            return np.asarray(m)[:, 0, :8], np.asarray(m)[:, 1, :8]

        def get_motion_embeddings(self, m, lens):
            return np.asarray(m)[:, 2, :8]

    stub = Stub()
    out = run_dualmdm_cross(stub, FakeGT(4), Hml(), Wrap(), EvalProtocol(),
                            sweep=[None, 0.0, 1.0], num_samples=4, batch_size=4, max_frames=T,
                            replications=1, seed=0)
    assert stub.force_influence_val == 0.7
    assert [kw for _, kw in stub.calls] == [{}, {"force_influence_val": 0.0},
                                             {"force_influence_val": 1.0}]
    assert len({s for s, _ in stub.calls}) == 1
    assert all(t.startswith("hml text") for t1, t2 in texts for t in t1 + t2)
    assert set(out["FID"]) == {"learned_influence", "force_influence_0", "force_influence_1"}


def test_one_generation_loop_and_one_text_fallback():
    """``generate_eval_set`` and ``EvaluationDatasetInterHuman`` are
    ``generate_batches``'s generated batches (the same motions, draws and
    lengths); a set without per-person texts gives both persons the
    caption, in the generated batches and the MultiModality replica sets
    alike; a splitter overrides the set's own texts."""
    from mixermdm_tpu_torch.eval import generate_eval_set
    from mixermdm_tpu_torch.eval.datasets import EvaluationDatasetInterHuman, \
        MMGeneratedDataset
    from mixermdm_tpu_torch.eval.driver import generate_batches

    texts = []

    class Stub(PortStub):
        def generate_cond(self, batch):
            texts.append((list(batch["text_individual1"]), list(batch["text_individual2"])))
            return super().generate_cond(batch)

    class NoPersons(FakeGT):
        def __getitem__(self, i):
            return {k: v for k, v in self.items[i].items() if not k.startswith("text_ind")}

    stub = Stub()
    _, want, ind = generate_batches(stub, NoPersons(), 5, num_samples=6, batch_size=4,
                                    per_item=False)
    got = generate_eval_set(stub, NoPersons(), 4, 6, seed=5)
    ds = EvaluationDatasetInterHuman(stub, NoPersons(), 5, num_samples=6, batch_size=4,
                                     max_frames=T)
    for (gt, gm, gl), (wt, wm, wl), (dt, dm, dl) in zip(got, want, ds.batches(4)):
        assert gt == wt == dt
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(dm, wm)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(dl, wl)
    assert len({s for s, _ in stub.calls}) == 2  # the seeds of batches 0 and 1, thrice
    n_generated = len(texts)
    MMGeneratedDataset(stub, NoPersons(), 5, mm_num_samples=2, mm_num_repeats=3, max_frames=T)
    assert len(texts) == n_generated + 2
    assert all(t1 == t2 for t1, t2 in texts)
    assert all(len(set(t1)) == 1 and t1[0].startswith("interaction") for t1, _ in texts[-2:])
    assert [t1 for t1, _ in ind] == [list(b[0]) for b in want]
    _, _, ind = generate_batches(stub, FakeGT(), 5, num_samples=6, batch_size=4,
                                 per_item=False, text_decomposer=lambda c: (c, ["x"] * len(c)))
    assert [t2 for _, t2 in ind] == [["x"] * 4, ["x"] * 2]


@pytest.mark.parametrize("name", ["identity", "heuristic"])
def test_get_decomposer_matches_jax(name):
    from mixermdm_tpu.eval.decompose import get_decomposer as j_get
    from mixermdm_tpu_torch.eval.decompose import get_decomposer

    captions = ["one person waves while the other person bows", "two people hug"]
    assert get_decomposer(name)(captions) == tuple(j_get(name)(captions))


def test_interleave_and_length_groups_match_jax():
    from mixermdm_tpu.eval import driver as J
    from mixermdm_tpu_torch.eval import driver as P

    gt = FakeGT(6)
    assert P.interleave(["a", "b"], ["c", "d"]) == J.interleave(["a", "b"], ["c", "d"])
    for per_item in (False, True):
        assert (list(P.length_groups(list(range(6)), gt, per_item, 2))
                == list(J.length_groups(list(range(6)), gt, per_item, 2)))


# --------------------------------------------------------------------------
# The ground-truth datasets
# --------------------------------------------------------------------------

def _same_items(got_ds, want_ds):
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert sorted(got) == sorted(want), i
        for k, v in want.items():
            if isinstance(v, (str, int)):
                assert got[k] == v, (i, k)
            else:
                np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-5, err_msg=f"{i} {k}")


@pytest.mark.parametrize("mode", ["train", "test"])
def test_interhuman_dataset_matches_jax(tmp_path, monkeypatch, mode):
    """Items of the port's InterHumanDataset equal the JAX dataset's, both
    drawing text, individual texts, crop and person swap from
    ``random.Random(7)`` in the same order (mixermdm_tpu/data/interhuman.py:
    152-176); crops happen (clips of 40-70 frames, 32 kept).  The JAX
    dataset runs its numpy path (its native library left out), the path the
    port copies."""
    from mixermdm_tpu.data import native
    from mixermdm_tpu.data.interhuman import InterHumanDataset as J
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.synthetic import make_interhuman_fixture

    monkeypatch.setattr(native, "get_lib", lambda: None)
    make_interhuman_fixture(str(tmp_path), n_clips=4, n_frames=[40, 70, 33, 55])
    got = InterHumanDataset(str(tmp_path), mode=mode, max_gt_length=32, rng=random.Random(7))
    want = J(str(tmp_path), mode=mode, max_gt_length=32, rng=random.Random(7))
    _same_items(got, want)
    _same_items(got, want)  # the second pass draws on from where the first stopped


@pytest.mark.parametrize("extended", [False, True])
def test_humanml3d_dataset_matches_jax(tmp_path, extended):
    """HumanML3D items, plain and ``extended`` (the motion and text
    duplicated into the two-person form the evaluation reads)."""
    from mixermdm_tpu.data.humanml3d import HumanML3DDataset as J
    from mixermdm_tpu_torch.data.humanml3d import HumanML3DDataset
    from mixermdm_tpu_torch.data.synthetic import make_hml3d_fixture

    make_hml3d_fixture(str(tmp_path), n_clips=3, n_frames=[20, 45, 31])
    got = HumanML3DDataset(str(tmp_path), mode="test", max_gt_length=32,
                           rng=random.Random(3), extended=extended)
    want = J(str(tmp_path), mode="test", extended=extended, max_gt_length=32,
             rng=random.Random(3))
    _same_items(got, want)
    if extended:
        item = got[1]
        assert item["motion2"] is item["motion1"] and item["text_individual1"] == item["text"]
