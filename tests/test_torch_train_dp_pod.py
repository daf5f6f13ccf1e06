"""The port's manual data-parallel step on a pod mesh against the JAX
package's, on the CPU: pod 2 x data 2, takum16 on the pod ring with error
feedback (the data ring uncompressed), reduced phi3-medium-14b at 2
layers; tests/test_torch_train_dp.py's child, job and checks (its module
docstring says what each holds). The error feedback the port carries is
the reference's bit for bit (replayed), and finite and not all zero; and
``python -m repro_torch.train.dp_selftest --world 4`` passes.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_train_dp import (check_free_running, check_ranks_and_bytes,
                                 check_replay_exact, check_replay_update,
                                 run_cases)

NAME = "pod2_data2_takum16"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases((NAME,), tmp_path_factory.mktemp("dp_pod"))


def test_replayed_chunk_and_error_feedback_are_bit_exact(runs):
    check_replay_exact(runs, NAME)


def test_replayed_norm_moments_and_parameters(runs):
    check_replay_update(runs, NAME)


def test_free_running_steps_match_the_reference(runs):
    check_free_running(runs, NAME, compressed=True)


def test_ranks_agree_and_bytes_equal_the_census(runs):
    check_ranks_and_bytes(runs, NAME)


def test_error_feedback_is_carried(runs):
    """Each rank's residual of the pod ring after three steps: finite, not
    all zero, and in the reference's place (``ef[pod, data]``) within the
    compressed run's tolerance of the reference's own."""
    ref = runs["ref"]
    want = ref[f"{NAME}/3/ef"]
    for rank in runs["free"][NAME]:
        ef = rank["state"]["ef"]
        c = rank["coords"]
        assert np.all(np.isfinite(ef)) and np.any(ef), c
        assert ef.shape == want[c["pod"], c["data"]].shape
    assert np.any(want)


def test_selftest_cli_on_four_ranks():
    """``python -m repro_torch.train.dp_selftest --world 4``: every case on
    the port's own weights, the ranks bit-equal, the census, data 2 against
    one rank."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.train.dp_selftest", "--world",
         "4"], cwd=root, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(root / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "DP SELFTEST OK"
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        "# data2", "# data2_takum16", "# pod2_data2_takum16",
        "# pod2_takum16"]
