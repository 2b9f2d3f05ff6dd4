"""Worker for the 2-process gloo test of the port's distributed helpers
(test_torch_eval.py::test_gather_rows_ragged_across_two_processes).

Run as: python tests/_torch_dist_worker.py <host:port> <num_procs> <rank>
Each process joins the group through ``init_distributed``, checks the
process helpers, gathers a ragged number of feature rows (rank r has 3 + r)
through ``eval/validation.py::_gather_rows`` and checks that every process
gets every row in process order, then meets the others at a barrier.
"""

import sys

import numpy as np


def main():
    coordinator, nproc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    from imagefolder_tpu_torch.eval.validation import _gather_rows
    from imagefolder_tpu_torch.parallel import dist

    assert dist.init_distributed(coordinator, nproc, rank, device="cpu")  # gloo
    assert dist.process_count() == nproc and dist.process_index() == rank
    assert dist.is_primary() == (rank == 0)

    def rows(r):
        return np.arange((3 + r) * 4, dtype=np.float32).reshape(3 + r, 4) + 100 * r

    got = _gather_rows(rows(rank))
    want = np.concatenate([rows(r) for r in range(nproc)])
    np.testing.assert_array_equal(got, want)
    dist.sync_global_devices("done")
    print("gather ok", got.shape)


if __name__ == "__main__":
    main()
