"""The port's multi-rank CLIs in ``--tiny`` on the CPU: each entered by two
ranks (``gloo``, ``FileStore`` rendezvous under the test's temporary
directory, one torch thread a rank; ``tests/torch_parallel_ranks.py:
cli_surface``), held row for row against the same CLI on one rank, which
this process runs while the ranks do; and on one rank, what the JAX CLIs
refuse.

Covered: ``infer-mixermdm --tp 2 --sp`` (window 16: SP applies), ``--pp
2`` and data parallelism; ``infer-in2in --pp 2``; ``eval-mixermdm`` and
``eval-base`` with data parallelism and ``eval-base --no-data-parallel``;
``serve`` with data parallelism answering two seeded requests.

The systems' zero-init layers are drawn from N(0, 0.02) on both sides
(``torch_parallel_ranks.nonzero_outputs``), else every motion is zeros.
Tolerance: :data:`ROW_TOL` 2e-4 of each row's max |value| (f32; the same
limit tests/test_torch_port_parallel.py holds rows to: a rank's products
run at other row counts than the single rank's).
"""

import json
import threading

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as R

ROW_TOL = 2e-4
LAUNCH_TIMEOUT_S = 150
PROMPTS = ["--text-interaction", "two people hug", "--text-individual1", "one hugs",
           "--text-individual2", "one hugs"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    for i in range(want.shape[0]):
        gap = np.abs(got[i] - want[i]).max() / np.abs(want[i]).max()
        assert gap <= ROW_TOL, (what, i, gap)


@pytest.fixture(scope="module")
def surface(tmp_path_factory):
    """(rank 0's report, rank 1's, the directory of the ranks' files, the
    directory of the single-rank runs, the single-rank serve rows)."""
    from mixermdm_tpu_torch import parallel
    from mixermdm_tpu_torch.cli import infer_in2in, infer_mixermdm

    out = tmp_path_factory.mktemp("ranks")
    single = tmp_path_factory.mktemp("single")
    ranks = {}

    def run():
        try:
            ranks["out"] = parallel.launch(R.cli_surface, 2, args=(str(out),), threads=1,
                                           timeout_s=LAUNCH_TIMEOUT_S, store_dir=str(out))
        except Exception as e:  # raised below, in the test's thread
            ranks["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    saved = infer_mixermdm.render, infer_mixermdm.build_system, infer_in2in.build_system
    infer_mixermdm.render = lambda *a, **k: None
    R.nonzero_outputs()  # as the ranks do
    try:
        infer_mixermdm.main(["--tiny", "--device", "cpu", "--name", "one", "--num-samples",
                             "2", "--out-dir", str(single), "--no-smooth"] + PROMPTS)
        infer_in2in.main(["--tiny", "--device", "cpu", "--name", "in2in", "--mode",
                          "interaction", "--text", "two people hug", "--num-samples", "2",
                          "--out-dir", str(single)])
        served = _single_rank_serve_rows(infer_mixermdm.build_system)
    finally:
        infer_mixermdm.render, infer_mixermdm.build_system, infer_in2in.build_system = saved
    thread.join(LAUNCH_TIMEOUT_S + 60)
    if "error" in ranks:
        raise ranks["error"]
    r0, r1 = ranks["out"]
    return r0, r1, out, single, served


def _single_rank_serve_rows(build_system):
    """What one rank's server answers the two seeded requests: its batch
    (2) of the prompt, sampled from each seed, row 0."""
    system = build_system(tiny=True, device="cpu")
    batch = {"text_interaction": ["two people hug"] * 2,
             "text_individual1": ["one hugs"] * 2, "text_individual2": ["one hugs"] * 2}
    rows = []
    with torch.inference_mode():
        cond = system.generate_cond(batch)
        for seed in (3, 4):
            out = system.sample(cond, 16, generator=torch.Generator().manual_seed(seed))
            rows.append(out[:1].numpy())
    return rows


@pytest.mark.parametrize("layout", ["tp", "pp", "dp"])
def test_infer_mixermdm_layouts_match_one_rank(surface, layout):
    r0, _, out, single, _ = surface
    want = np.load(single / "one_motion.npy")
    _rows_close(np.load(out / f"{layout}_motion.npy"), want, layout)
    for k in ("i1", "i2"):
        _rows_close(np.load(out / f"{layout}_influence_{k}.npy").swapaxes(0, 1),
                    np.load(single / f"one_influence_{k}.npy").swapaxes(0, 1), (layout, k))
    said = {"tp": "tp 2 + sp x data 1 of 2 ranks", "pp": "pp 2 of 2 ranks",
            "dp": "data 2 of 2 ranks"}[layout]
    assert said in r0["log"], r0["log"]


def test_infer_in2in_pp_matches_one_rank(surface):
    r0, _, out, single, _ = surface
    _rows_close(np.load(out / "in2in_pp_motion.npy"), np.load(single / "in2in_motion.npy"),
                "in2in")
    assert "interaction, pp 2)" in r0["log"]


def test_eval_clis_data_parallel(surface):
    """eval-mixermdm and eval-base split their generation over both ranks;
    eval-base --no-data-parallel does not; rank 0 writes each summary."""
    r0, r1, out, _, _ = surface
    log = r0["log"]
    assert log.count("data-parallel generation over 2 ranks") == 2, log
    tail = log.split("== eval-base --no-data-parallel ==")[1]
    assert "data-parallel generation" not in tail
    assert "2-rank data mesh" in log
    assert "wrote" not in r1["log"]
    ih = json.loads((out / "eval.json").read_text())["interhuman"]
    assert {"MM Distance", "FID", "Diversity", "MultiModality"} <= set(ih)
    for name in ("eval_base.json", "eval_base_1.json"):
        hml = json.loads((out / name).read_text())["hml3d"]
        assert np.isfinite(hml["FID"]["in2INind"][0]), name


def test_serve_data_parallel_two_requests(surface):
    """Rank 0 served two seeded requests over both ranks; rank 1 sampled
    its rows of both dispatches and of the warm-up, then stopped; each
    answer is the one-rank server's row."""
    r0, r1, _, _, served = surface
    assert r0["batch"] == 2 and r1["served"] == 3
    for reply, want, seed in zip(r0["replies"], served, (3, 4)):
        assert reply["seed"] == seed and reply["shape"] == [1, 16, 524]
        _rows_close(np.asarray(reply["motion"], np.float32), want, ("serve", seed))


@pytest.mark.parametrize("argv, said", [
    (["--tp", "2"], "--tp 2 does not divide 1 devices"),
    (["--sp"], "--sp requires --tp > 1"),
    (["--pp", "2", "--tp", "2"], "--pp and --tp are mutually exclusive"),
    (["--pp", "2"], "--pp 2 > 1 available devices"),
])
def test_infer_mixermdm_refuses_as_jax_does(tmp_path, argv, said):
    from mixermdm_tpu_torch.cli import infer_mixermdm

    with pytest.raises(SystemExit, match=said.replace("+", r"\+")):
        infer_mixermdm.main(["--tiny", "--device", "cpu", "--name", "x",
                             "--out-dir", str(tmp_path)] + PROMPTS + argv)


def test_infer_in2in_refuses_pp_beyond_the_ranks(tmp_path):
    from mixermdm_tpu_torch.cli import infer_in2in

    with pytest.raises(SystemExit, match="--pp 2 > 1 available devices"):
        infer_in2in.main(["--tiny", "--device", "cpu", "--name", "x", "--text", "hug",
                          "--out-dir", str(tmp_path), "--pp", "2"])
