"""The collective data plane of ``dist_device_sync`` (the port of
``mxnet_tpu/kvstore/collective.py``): every push is an allreduce across
the workers over ``torch.distributed``, with no parameter server, as the
reference's ``dist_device_sync`` reduces on its GPUs (ref:
src/kvstore/kvstore_dist.h comm_ device reduce; kvstore.cc:55).

The rendezvous is the launcher's (``tools/launch.py -s 0`` of this
package): ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` (no server binds
it; worker 0's TCP store does), ``DMLC_NUM_WORKER`` and
``DMLC_WORKER_ID``. The worker's device is chosen by the caller, never by
probing: NCCL when it is a CUDA device, gloo when it is the CPU. A failed
NCCL init raises; nothing falls back to gloo. The collectives run on the
device in the value's own dtype (64-bit included), with no host round
trip.
"""
from __future__ import annotations

import datetime
import os
import threading

import torch
import torch.distributed as tdist

from ..base import MXNetError

_lock = threading.Lock()
_instance = None


class CollectiveConn:
    """The process's one collective group over ``torch.distributed``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.backend = "nccl" if self.device.type == "cuda" else "gloo"
        if not tdist.is_initialized():
            uri = os.environ.get("DMLC_PS_ROOT_URI")
            port = os.environ.get("DMLC_PS_ROOT_PORT")
            if not (uri and port):
                raise MXNetError(
                    "collective kvstore needs DMLC_PS_ROOT_URI/PORT (set by "
                    "this package's tools/launch.py -s 0) or an initialized "
                    "torch.distributed process group")
            n = int(os.environ.get("DMLC_NUM_WORKER", "1"))
            rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
            kwargs = {}
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                kwargs["device_id"] = self.device
            try:
                tdist.init_process_group(
                    self.backend, init_method=f"tcp://{uri}:{port}",
                    world_size=n, rank=rank,
                    timeout=datetime.timedelta(seconds=120), **kwargs)
            except Exception as e:  # noqa: BLE001 — any init failure
                raise MXNetError(
                    f"cannot join the {self.backend} group at {uri}:{port} "
                    f"as rank {rank} of {n} on {self.device}: {e}") from e
        elif tdist.get_backend() != self.backend:
            raise MXNetError(
                f"torch.distributed is initialized with "
                f"{tdist.get_backend()}, but {self.device} needs "
                f"{self.backend}")
        self.rank = tdist.get_rank()
        self.num_workers = tdist.get_world_size()

    @classmethod
    def get(cls, device):
        """The process's connection, made on first use for ``device``
        (a ``torch.device``); a later call for another device raises."""
        global _instance
        with _lock:
            if _instance is None:
                _instance = cls(device)
            elif _instance.device != torch.device(device):
                raise MXNetError(
                    f"the collective group runs on {_instance.device}, "
                    f"not {device}")
            return _instance

    def _own(self, value):
        if not isinstance(value, torch.Tensor) or \
                value.device != self.device:
            raise MXNetError(
                f"collective values must be tensors on {self.device}, got "
                f"{type(value).__name__} on "
                f"{getattr(value, 'device', 'the host')}")
        return value.detach().clone(memory_format=torch.contiguous_format)

    def allreduce(self, value):
        """The sum of ``value`` (a tensor on this worker's device) over
        every worker: a new tensor of its shape and dtype."""
        out = self._own(value)
        tdist.all_reduce(out, op=tdist.ReduceOp.SUM)
        return out

    def broadcast(self, value, root=0):
        """``root``'s ``value`` on every worker (the reference's kvstore
        init: rank 0 seeds, everyone pulls)."""
        out = self._own(value)
        tdist.broadcast(out, src=root)
        return out

    def barrier(self):
        """A fence every worker must join: a one-element allreduce."""
        self.allreduce(torch.zeros(1, device=self.device))

    def close(self):
        """Leave the group (every worker calls it)."""
        global _instance
        with _lock:
            if tdist.is_initialized():
                tdist.destroy_process_group()
            _instance = None
