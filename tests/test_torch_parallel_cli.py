"""`python -m mpopis_tpu_torch car --sharded` on the CPU, and how a run of
several ranks ends when one of them fails.

Under `torch.distributed.run` with two gloo ranks the run prints one table,
from rank 0, equal to the unsharded run's (the execution time aside); alone
with `--device cpu` it is one gloo rank and prints the same, and alone on
a machine of two cards (stood in for by two gloo ranks on the CPU) it
starts one rank per card and prints the same again. A rank that
raises fails the run at once, and a run that outlasts its deadline is
stopped: no rank hangs the others.
"""

import os
import subprocess
import sys
import time

import pytest
from torch.multiprocessing import ProcessRaisedException
from torch_parallel_ranks import fail_one_rank

from mpopis_tpu_torch.harness import cli
from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.parallel.mesh import spawn_ranks

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAR = ["car", "--device", "cpu", "--samples", "16", "--horizon", "5", "--ais-its", "2",
       "--steps", "5", "--seed", "1"]


def _table(out: str) -> list:
    """The banner, the trial row and the summary rows, each row without
    its last column (the execution time)."""
    keep = []
    for line in out.splitlines():
        if line.startswith(("Trial ", "Trials ")):
            line = line.rsplit(":", 1)[0]
        keep.append(line.rstrip())
    return [line for line in keep if line]


@pytest.fixture(scope="module", autouse=True)
def torchrun(tmp_path_factory):
    """`car --sharded` under `torch.distributed.run` with two gloo ranks,
    started with the file so that it runs beside the other tests: the
    process and the files of its output and its errors."""
    d = tmp_path_factory.mktemp("torchrun")
    out, err = d / "out.txt", d / "err.txt"
    with open(out, "w") as o, open(err, "w") as e:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", "mpopis_tpu_torch", *CAR, "--sharded"],
            cwd=_REPO, stdout=o, stderr=e, text=True,
        )
    try:
        yield proc, out, err
    finally:
        if proc.poll() is None:
            proc.terminate()
        proc.wait(timeout=60)


def test_sharded_car_alone_on_the_cpu_is_one_gloo_rank(capsys):
    assert main(CAR + ["--sharded"]) == 0
    got = _table(capsys.readouterr().out)
    assert main(CAR) == 0
    assert got == _table(capsys.readouterr().out)


def test_sharded_car_alone_starts_one_rank_per_card(monkeypatch, capfd):
    # two "cards" on the CPU: the spawned ranks run gloo on the CPU
    monkeypatch.setattr(cli, "_ranks_alone", lambda device: 2)
    assert main(CAR + ["--sharded"]) == 0
    out = capfd.readouterr().out
    assert out.count("Sim Type:") == 1  # rank 0 alone prints
    assert main(CAR) == 0
    want = _table(capfd.readouterr().out)
    assert any(line.startswith("Trials AVE") for line in want)
    assert _table(out) == want


def test_a_failed_rank_fails_the_run_and_a_deadline_stops_it(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException, match="rank 1 fails on purpose"):
        spawn_ranks(fail_one_rank, 2, args=(2, f"file://{tmp_path / 'a'}"), timeout=120.0)
    # rank 0 alone of a 2-rank group waits for rank 1 until its deadline
    with pytest.raises(TimeoutError, match="still running after 2 s"):
        spawn_ranks(fail_one_rank, 1, args=(2, f"file://{tmp_path / 'b'}"), timeout=2.0)
    assert time.monotonic() - t0 < 60.0


def test_sharded_car_under_torchrun_prints_the_unsharded_table(torchrun, capsys):
    proc, out, err = torchrun
    assert main(CAR) == 0
    want = _table(capsys.readouterr().out)
    assert proc.wait(timeout=180) == 0, out.read_text() + err.read_text()
    got = out.read_text()
    assert got.count("Sim Type:") == 1  # rank 0 alone prints
    assert any(line.startswith("Trials AVE") for line in want)
    assert _table(got) == want
