"""Online rollout loop: the train↔serve cycle the fleet exists for
(counterpart of ``workloads/rollout_loop.py``; the RLHF and online
distillation shape, the hot weight push of HotSPa).

One process, every round:

1. rollout: the fleet's Router fans ``generate_many`` over N in-process
   ``ServingEngine`` replicas;
2. train: the (prompt, rollout) pairs feed ``SFTTrainer`` (the
   response-masked loss) for a few captured steps;
3. publish: ``WeightPublisher`` pushes the trainer's weights into every
   replica, rolling drain → swap → resume, while a trickle of requests
   keeps arriving. The ledger (submitted == completed, none rejected)
   is the zero-downtime evidence, and every replica ends at the new
   version.

Self-distillation on random tokens learns nothing of interest: the loop
exercises the plumbing end to end and reports per-round rollout tokens
and time, the train loss, the push time, the requeues and the ledger.

    python -m hetu_tpu_torch.workloads.rollout_loop --model small
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np


def run_rollout_loop(*, rounds: int = 2, n_replicas: int = 2,
                     prompts_per_round: int = 8, max_tokens: int = 8,
                     steps_per_round: int = 4, model_size: str = "tiny",
                     slots: int = 4, max_len: int = 64,
                     prefill_chunk: int = 16, seq_len: int = 32,
                     batch_size: int = 4, lr: float = 1e-3,
                     trickle: int = 4, seed: int = 0, device=None) -> dict:
    """Drive ``rounds`` rollout → train → publish cycles; returns the
    summary (per-round stats and the continuity ledger). The trainer runs
    as ``TrainerConfig`` does by default (bf16 compute over fp32
    parameters); each replica serves its own fp32 copy of the trainer's
    weights. ``device=None`` means ``cuda``."""
    from hetu_tpu_torch import optim, resolve_device, telemetry
    from hetu_tpu_torch.engine import SFTTrainer
    from hetu_tpu_torch.engine.trainer import TrainerConfig
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.parallel import Strategy
    from hetu_tpu_torch.rpc.launcher import launch_serving_fleet
    from hetu_tpu_torch.serving import (
        SamplingParams, ServingEngine, WeightPublisher,
    )

    dev = resolve_device(device)
    telemetry.enable(True)
    cfg = GPTConfig.small() if model_size == "small" else GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    trainer = SFTTrainer(
        model, optim.adamw(lr), Strategy(),
        TrainerConfig(total_steps=steps_per_round, log_every=1),
        device=dev)
    trainer.initialize()

    def build_engine(i):
        # each replica serves its own copy: a swap writes a replica's
        # tensors in place, and the trainer's step writes its own
        replica = GPTLMHeadModel(cfg, device=dev, seed=seed).eval()
        replica.load_state_dict(trainer.model.state_dict())
        return ServingEngine(replica, slots=slots, max_len=max_len,
                             prefill_chunk=prefill_chunk, device=dev)

    fleet = launch_serving_fleet(build_engine, n_replicas)
    publisher = WeightPublisher(fleet.router)
    rng = np.random.default_rng(seed)
    sp = SamplingParams(max_tokens=max_tokens)
    plen_hi = max_len - max_tokens - 1
    ledger = {"submitted": 0, "completed": 0, "rejected": 0}
    per_round = []
    try:
        for rnd in range(rounds):
            prompts = [rng.integers(
                1, cfg.vocab_size,
                (int(rng.integers(4, min(16, plen_hi))),)).tolist()
                for _ in range(prompts_per_round)]
            t0 = time.perf_counter()
            outs = fleet.router.generate_many(prompts, sp)
            roll_s = time.perf_counter() - t0
            history = trainer.fit(
                [np.asarray(p, np.int32) for p in prompts],
                [np.asarray(o, np.int32) for o in outs],
                seq_len=seq_len, batch_size=batch_size,
                steps=steps_per_round, shuffle=False)
            loss = next((h["loss"] for h in reversed(history)
                         if "loss" in h), None)
            # publish under a concurrent trickle: the continuity ledger
            # is the zero-downtime evidence
            trickle_reqs = []

            def submit_trickle():
                for _ in range(trickle):
                    p = rng.integers(1, cfg.vocab_size, (6,)).tolist()
                    trickle_reqs.append(fleet.router.submit(p, sp))
                    time.sleep(0.002)

            t = threading.Thread(target=submit_trickle)
            t.start()
            push = publisher.publish(trainer.state)
            t.join()
            for r in trickle_reqs:
                r.done.wait(60.0)
                ledger["submitted"] += 1
                ledger["completed"] += int(r.status == "done")
                ledger["rejected"] += int(r.status == "rejected")
            fleet_doc = fleet.router.fleet_status()
            per_round.append({
                "round": rnd,
                "rollout_tokens": sum(len(o) for o in outs),
                "rollout_s": roll_s,
                "loss": None if loss is None else float(loss),
                "push_ms": push["duration_ms"],
                "weight_version": push["version"],
                "fleet_versions": fleet_doc["weight_versions"],
                "requeues_total": fleet_doc["requeues_total"],
            })
    finally:
        fleet.stop()
        trainer.close()
    return {
        "rounds": per_round,
        "continuity": ledger,
        "replicas": n_replicas,
        "zero_downtime": ledger["submitted"] == ledger["completed"]
        and ledger["rejected"] == 0,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--model", default="tiny", choices=("tiny", "small"))
    ap.add_argument("--trickle", type=int, default=4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    out = run_rollout_loop(
        rounds=args.rounds, n_replicas=args.replicas,
        prompts_per_round=args.prompts, max_tokens=args.max_tokens,
        steps_per_round=args.steps, model_size=args.model,
        trickle=args.trickle, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
