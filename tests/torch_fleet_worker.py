"""One fleet worker's session traffic as a real OS process, on the port
(not collected by pytest): ``tests/test_torch_fleet.py`` starts

    python tests/torch_fleet_worker.py LOG_ROOT SESSION N_ROUNDS [SLEEP_S]

It drives a durable market session of the port on the CPU in float64
(deterministic per-(round, block) event blocks, two appends then a
resolve a round) against a replication log, printing a marker after each
step. The test SIGKILLs it mid-round and a standby replays the log; every
append is journaled before it is acknowledged and every resolve commits
the ledger before clearing its journal, so the standby resumes bit for
bit wherever the kill landed. If the log exists already the worker
replays it and continues from its durable position.
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

N_REPORTERS = 12
BLOCK_EVENTS = 5
BLOCKS_PER_ROUND = 2


def make_block(round_idx: int, block_idx: int) -> np.ndarray:
    """The event block of (round, block): the parent regenerates the same
    traffic to continue after the kill and to build the never-killed
    run."""
    rng = np.random.default_rng([7, round_idx, block_idx])
    block = rng.choice([0.0, 1.0], size=(N_REPORTERS, BLOCK_EVENTS))
    block[rng.random(block.shape) < 0.1] = np.nan
    return block


def main(argv) -> int:
    import torch

    from pyconsensus_tpu_torch.serve.failover import (DurableSession,
                                                      ReplicationLog,
                                                      replay_session)

    torch.set_default_dtype(torch.float64)
    log_root, name = argv[1], argv[2]
    n_rounds = int(argv[3])
    sleep_s = float(argv[4]) if len(argv) > 4 else 0.15
    if ReplicationLog(log_root, name).exists():
        session = replay_session(log_root, name, device="cpu")
    else:
        session = DurableSession.create(log_root, name, N_REPORTERS,
                                        device="cpu")
    print(f"READY round={session.ledger.round} "
          f"staged={len(session._blocks)}", flush=True)
    for k in range(session.ledger.round, n_rounds):
        for j in range(len(session._blocks), BLOCKS_PER_ROUND):
            session.append(make_block(k, j))
            print(f"APPEND {k} {j}", flush=True)
            time.sleep(sleep_s)
        session.resolve()
        print(f"ROUND {k}", flush=True)
        time.sleep(sleep_s)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
