"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases and comparison helpers work at small sizes (their card-vs-CPU
comparisons become CPU-vs-CPU here)."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.parametrize("pairs_b, expected", [
    ([[0, 5], [1, 6]], 1.0),
    ([[0, 5]], 0.5),
    ([[2, 7]], 0.0),
])
def test_jaccard(pairs_b, expected):
    assert cs.jaccard(np.array([[0, 5], [1, 6]]), np.array(pairs_b)) == expected


def test_verdicts_collect_failures(capsys):
    v = cs.Verdicts()
    v.check("inside", 1e-6, "<= 1e-5", True)
    v.check("outside", 1e-3, "<= 1e-5", False)
    assert v.failed == ["outside"]
    out = capsys.readouterr().out
    assert "[PASS] inside" in out and "[FAIL] outside" in out


def test_phase_p_small():
    v = cs.Verdicts()
    cs.phase_p(v, n=400, g=64, k=8)
    assert v.failed == []


def test_phase_b_small():
    v = cs.Verdicts()
    cs.phase_b(v, n=1500, n_cmp=600)
    assert v.failed == []
