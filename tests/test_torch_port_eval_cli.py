"""The evaluation CLIs of the port.

``eval-mixermdm``, ``eval-base`` (its four modes) and ``train-evaluator``
run at ``--tiny`` on the CPU in a fresh interpreter where jax, flax, optax,
orbax, yaml and the JAX package cannot be imported (the guard of
tests/test_torch_port_sample.py); the evaluator files ``train-evaluator``
writes load back through ``eval-mixermdm --evaluator-checkpoint
--evaluator-individual-checkpoint --strict``.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_port_sample import run_blocked


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_eval_clis_run_without_jax_yaml_or_the_jax_package(tmp_path):
    """The three CLIs end to end at ``--tiny`` (one replication): both
    dataset sides, the F-score, the DualMDM cross sweep and the heuristic
    decomposer; ``eval-base`` in each mode; ``train-evaluator`` in both
    modes, its files read back ``--strict`` with every parameter filled."""
    out = str(tmp_path)
    code = f"""
        from mixermdm_tpu_torch.__main__ import main as cli
        def run(*argv):
            sys.argv = ["mixermdm_tpu_torch", *argv, "--tiny", "--device", "cpu"]
            assert (cli() or 0) == 0, argv
        for mode in ("interaction", "individual"):
            run("train-evaluator", "--mode", mode, "--max-steps", "2",
                "--out-dir", {out!r} + "/ev_" + mode)
        run("eval-mixermdm", "--replications", "1", "--dualmdm-cross", "--decompose",
            "heuristic", "--out", {out!r} + "/mixer.json")
        run("eval-mixermdm", "--replications", "1", "--mm-num-samples", "0", "--strict",
            "--evaluator-checkpoint", {out!r} + "/ev_interaction/final.ckpt",
            "--evaluator-individual-checkpoint", {out!r} + "/ev_individual/final.ckpt",
            "--out", {out!r} + "/trained.json")
        for mode in ("interaction", "individual", "dual", "mdm"):
            run("eval-base", "--mode", mode, "--replications", "1",
                "--out", {out!r} + "/base_" + mode + ".json")
    """
    res = run_blocked(code)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "blocked imports held" in res.stdout
    # --tiny: one epoch (the individual fixture holds one batch)
    assert res.stdout.count("evaluator training done: ") == 2
    loaded = [ln.split()[1] for ln in res.stdout.splitlines() if ln.startswith("loaded ")]
    assert len(loaded) == 2 and all(a == b for a, b in (x.split("/") for x in loaded)), loaded
    mixer = json.loads((tmp_path / "mixer.json").read_text())
    assert set(mixer) == {"interhuman", "hml3d", "f_score", "dualmdm_cross"}
    metrics = {"MM Distance", "R_precision_top1", "R_precision_top2", "R_precision_top3",
               "Diversity", "FID", "MultiModality"}
    assert set(mixer["interhuman"]) == set(mixer["f_score"]) == metrics
    assert all(np.isfinite(v).all() for side in ("interhuman", "hml3d")
               for d in mixer[side].values() for v in d.values())
    assert "MultiModality" not in json.loads((tmp_path / "trained.json").read_text())["hml3d"]
    for mode, sides in (("interaction", {"interhuman", "hml3d"}), ("individual", {"hml3d"}),
                        ("dual", {"interhuman", "hml3d"}), ("mdm", {"hml3d"})):
        base = json.loads((tmp_path / f"base_{mode}.json").read_text())
        assert set(base) == sides, mode
    assert "generation:" in res.stdout and "scoring:" in res.stdout
