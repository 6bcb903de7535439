"""The bench record must ALWAYS land, and must name its device.

bench.py prints one JSON line at the end of a run, so a hang or a driver
timeout would erase the record: the bench enforces its own wall budget
with a watchdog that emits the cumulative partial record and exits. These
tests prove the guarantee the reference gives via its always-printed TIMING
table (/root/reference/API/src/util.t:469-508): a record is produced even
when a case blocks forever. They run on the CPU through the explicit
OPT_TPU_BENCH_FORCE_CPU switch; without it the bench refuses to run cases
on anything but a GPU.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


def _run_bench(env_extra, timeout=150):
    env = dict(os.environ)
    env.update({"OPT_TPU_BENCH_FORCE_CPU": "1"})
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, BENCH],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
        cwd=REPO,
    )


def _last_json_line(stdout):
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    assert lines, f"no stdout produced: {stdout!r}"
    return json.loads(lines[-1])


def test_hung_case_is_killed_and_run_continues(tmp_path):
    """A case that blocks forever burns only its own timeout: the parent
    kills the subprocess, records null metrics for it, and the final JSON
    still prints (the first live run of the watchdog-only harness lost 8
    cases to one hung case)."""
    proc = _run_bench(
        {
            "BENCH_BUDGET_S": "120",
            "BENCH_CASE_TIMEOUT_S": "8",
            "OPT_TPU_BENCH_SIMULATE_HANG": "poisson",
            "OPT_TPU_BENCH_CASES": "poisson",
        }
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = _last_json_line(proc.stdout)
    assert out["metric"] == "pcg_iters_per_sec_poisson512_float4"
    assert out["value"] is None  # the hung case recorded nothing
    assert "TIMED OUT" in proc.stderr
    # the loop CONTINUED past the hang (poisson is marked attempted)
    assert "poisson" not in out["extra"]["truncated"]["cases_not_run"]
    # the bench keeps no record files of its own
    assert not os.path.exists(os.path.join(REPO, "BENCH_LIVE.json"))


def test_inproc_hang_triggers_watchdog():
    """In-process mode (no subprocess isolation) falls back to the
    watchdog: a blocked case still yields the parsed partial record."""
    proc = _run_bench(
        {
            "BENCH_BUDGET_S": "120",
            "BENCH_CASE_TIMEOUT_S": "8",
            "OPT_TPU_BENCH_INPROC": "1",
            "OPT_TPU_BENCH_SIMULATE_HANG": "poisson",
            "OPT_TPU_BENCH_CASES": "poisson",
        }
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = _last_json_line(proc.stdout)
    assert "WATCHDOG" in proc.stderr
    assert "poisson" in out["extra"]["truncated"]["cases_not_run"]


def test_exhausted_budget_emits_record_without_running_cases():
    """With no budget left, every case is skipped but the JSON line still
    prints, tagged truncated, with all metric keys present as null."""
    proc = _run_bench({"BENCH_BUDGET_S": "5"}, timeout=90)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = _last_json_line(proc.stdout)
    assert out["value"] is None
    assert out["vs_baseline"] is None
    assert out["device"] is None  # no case ran, so no device was opened
    tr = out["extra"]["truncated"]
    assert len(tr["cases_not_run"]) == 13
    # the record schema is complete even when nothing ran
    for key in (
        "gn_iters_per_sec_arap36k_vertices",
        "gn_iters_per_sec_sfs512",
        "batched_lm_curvefits_per_sec",
    ):
        assert key in out["extra"] and out["extra"][key] is None


@pytest.mark.slow
def test_case_selection_runs_only_selected_case():
    """OPT_TPU_BENCH_CASES restricts the run; the batched curve-fit case is
    the fastest real solve."""
    proc = _run_bench(
        {
            "BENCH_BUDGET_S": "600",
            "BENCH_CASE_TIMEOUT_S": "540",
            "OPT_TPU_BENCH_CASES": "batched",
        },
        timeout=620,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = _last_json_line(proc.stdout)
    assert out["extra"]["batched_lm_curvefits_per_sec"] is not None
    assert out["extra"]["batched_curvefit_max_param_err"] < 1e-3
    assert out["extra"]["truncated"]["reason"] == "case selection"
    assert out["extra"]["gn_iters_per_sec_sfs512"] is None
    assert out["device"]["platform"] == "cpu"


def test_case_without_gpu_fails_instead_of_falling_back():
    """Without OPT_TPU_BENCH_FORCE_CPU a case that finds no GPU fails (its
    metrics stay null); the bench never moves itself to the CPU."""
    env = dict(os.environ)
    env.pop("OPT_TPU_BENCH_FORCE_CPU", None)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "BENCH_BUDGET_S": "120",
        "OPT_TPU_BENCH_INPROC": "1",
        "OPT_TPU_BENCH_CASES": "batched",
    })
    proc = subprocess.run(
        [sys.executable, BENCH], capture_output=True, text=True,
        timeout=150, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = _last_json_line(proc.stdout)
    assert "no GPU" in proc.stderr
    assert out["extra"]["batched_lm_curvefits_per_sec"] is None
    assert out["device"] is None
