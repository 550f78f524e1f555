"""The control plane's wire (counterpart of ``hetu_tpu/rpc/``, cut to what
the serving front end runs): the coordinator server with its line
protocol and stream mode, the length-framed stream channel, the client,
and the launcher of an in-process serving fleet.
"""

from hetu_tpu_torch.rpc.client import CoordinatorClient
from hetu_tpu_torch.rpc.launcher import FleetHandle, launch_serving_fleet
from hetu_tpu_torch.rpc.py_server import PyCoordinatorServer
from hetu_tpu_torch.rpc.stream import StreamChannel

__all__ = ["CoordinatorClient", "FleetHandle", "PyCoordinatorServer",
           "StreamChannel", "launch_serving_fleet"]
