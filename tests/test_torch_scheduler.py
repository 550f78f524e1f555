"""The port's scheduler and prefix cache against ``hetu_tpu``'s, on the
host: the same mixed-priority requests, with shared prefixes (whole-block
hits plus copy-on-write tails) and an arena small enough to force
prefix-cache eviction and head-of-line waits, must be admitted in the
same order with the same block tables and prefill offsets.
"""

import numpy as np
import pytest
import torch

from hetu_tpu.serving import kv_pool as jax_kv_pool
from hetu_tpu.serving import prefix_cache as jax_prefix_cache
from hetu_tpu.serving import scheduler as jax_scheduler

from hetu_tpu_torch.serving import kv_pool, prefix_cache, scheduler

torch.set_num_threads(2)

BLOCK, MAX_LEN, NEW = 4, 64, 6


def _workload(seed):
    rng = np.random.default_rng(seed)
    system = rng.integers(1, 100, 10).tolist()           # 2.5 blocks
    out = []
    for i in range(14):
        tail = rng.integers(1, 100, int(rng.integers(1, 12))).tolist()
        prompt = system + tail if i % 3 else tail + system[:3]
        out.append((prompt, int(rng.integers(0, 3))))
    out.append((list(range(1, 70)), 1))                  # never fits a slot
    return out


def _drive(mods, n_blocks, slots, seed):
    """Admit everything admissible, cache each admitted prompt (as the
    engine does when its prefill completes), then finish the oldest
    running request; repeat until the queue drains. Returns the
    admission log and the rejected ids."""
    kvp, pcm, sch = mods
    blocks = kvp.BlockManager(n_blocks)
    cache = pcm.PrefixCache(BLOCK, blocks)
    sched = sch.Scheduler(slots, MAX_LEN, blocks=blocks, prefix_cache=cache,
                          block_size=BLOCK)
    rejected = []
    for i, (prompt, prio) in enumerate(_workload(seed)):
        req = sch.Request(id=i, prompt=np.asarray(prompt, np.int32),
                          sampling=sch.SamplingParams(max_tokens=NEW,
                                                      priority=prio),
                          submit_s=0.0)
        if not sched.submit(req):
            rejected.append(i)
    log, running = [], []
    while sched.queue or running:
        while (adm := sched.next_admission()) is not None:
            req, slot = adm
            plan = req.admit
            log.append((req.id, slot, list(plan["table"]),
                        plan["first_uncached"], plan["cow"],
                        req.cached_tokens, blocks.free_blocks))
            cache.insert(req.prompt.tolist(), plan["table"])
            running.append((slot, plan["table"]))
        assert running, "admission stalled with nothing running"
        slot, table = running.pop(0)
        sched.release(slot, table=table)
    return log, rejected


@pytest.mark.parametrize("n_blocks,slots,seed", [
    (60, 2, 0),      # roomy arena: priority order + prefix hits
    (11, 3, 1),      # tight arena: cache eviction, heads wait for blocks
])
def test_scheduler_admissions_match_jax(n_blocks, slots, seed):
    want = _drive((jax_kv_pool, jax_prefix_cache, jax_scheduler),
                  n_blocks, slots, seed)
    got = _drive((kv_pool, prefix_cache, scheduler), n_blocks, slots, seed)
    assert got == want
    log, rejected = got
    assert rejected == [14]
    assert len(log) == 14
    assert any(cow is not None for *_, cow, _, _ in log)     # CoW tails
    assert any(hit >= 2 * BLOCK for *_, hit, _ in log)       # whole blocks
    # mixed priorities: the admission order is not submission order
    assert [e[0] for e in log] != sorted(e[0] for e in log)
