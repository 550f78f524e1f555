"""Workloads over the port (counterparts of ``workloads/``): the online
rollout loop that closes the train→serve cycle through the fleet."""

from hetu_tpu_torch.workloads.rollout_loop import run_rollout_loop

__all__ = ["run_rollout_loop"]
