"""The port's trainers in a multi-process run (``parallel/dist.py``): one
step of each on two gloo processes, each with half of the global batch,
against one process on the whole batch (``tests/_torch_dp_worker.py``
runs both at once on the CPU). Every random draw is made for the global
batch from the shared seed and sliced, so the two runs draw the same; the
gradients are averaged over the processes before the clip; the batch
statistics (the usage counts, LeCam's means, the quantizers' active
shares, BSQ's batch entropy, the semantic guide's InfoNCE over the gathered
features, DinoDisc's virtual-batch norm across the two shards) are the
global batch's.

Cases: the flagship GAN step at a tiny preset (ViT width 64, 2 blocks,
DinoDisc at 2 blocks, half the batch under quantizer dropout), the MSBR
(BSQ) YAML at the same preset, ``VARTrainer`` (VAR-d2, EMA on),
``RARTrainer`` and ``MaskGITTrainer`` (width 64, 2 blocks).

Tolerance: every tensor the step leaves (parameters, buffers, averaged
gradients, Adam's moments, EMAs, usage, LeCam, metrics) within 1e-6 of its
max abs (1e-6 absolute under a max of 1) between the runs: the two differ
only in the order of fp32 sums over the batch. The two processes of the
two-process run hold the same state bit for bit.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CASES = ("tokenizer", "tokenizer_bsq", "var", "rar", "maskgit")
TOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process on the whole batch and two on halves, all at once."""
    out = tmp_path_factory.mktemp("dp")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, str(ROOT / "tests" / "_torch_dp_worker.py")]
    procs = [subprocess.Popen(cmd + [f"localhost:{port}", "2", str(r), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    procs.append(subprocess.Popen(cmd + ["localhost:0", "1", "0", str(out)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        stdout, err = p.communicate(timeout=300)
        assert p.returncode == 0 and "dp ok" in stdout, err[-3000:]
    return out


@pytest.mark.parametrize("case", CASES)
def test_two_processes_step_as_one_on_the_whole_batch(runs, case):
    one = torch.load(runs / f"{case}_1_0.pt")
    two = [torch.load(runs / f"{case}_2_{r}.pt") for r in range(2)]
    assert set(one) == set(two[0]) == set(two[1])
    assert any(k.endswith(".grad") for k in one)
    for k, want in one.items():
        assert torch.equal(two[0][k], two[1][k]), f"{case} {k}: the replicas differ"
        got = two[0][k]
        assert got.shape == want.shape, k
        if not want.is_floating_point():
            assert torch.equal(got, want), f"{case} {k}"
            continue
        scale = max(want.abs().max().item(), 1.0) if want.numel() else 1.0
        err = (got - want).abs().max().item() if want.numel() else 0.0
        assert err <= TOL * scale, f"{case} {k}: {err:.3e} of max {scale:.3e}"


def test_world_of_one_helpers_are_identities():
    """Without a process group every helper returns its input (the same
    object) and leaves gradients as they are."""
    from imagefolder_tpu_torch.parallel import dist

    x = torch.randn(3, 2, requires_grad=True)
    assert dist.global_sum(x) is x and dist.global_mean(x) is x
    assert dist.all_gather_batch(x) is x and dist.own_rows(x, 3) is x
    m = {"a": torch.tensor(1.0)}
    assert dist.global_metrics(m) is m
    g = [torch.ones(2)]
    dist.all_reduce_mean_(g)
    assert torch.equal(g[0], torch.ones(2))
    assert dist.global_batch_rows(5) == (0, 5)
