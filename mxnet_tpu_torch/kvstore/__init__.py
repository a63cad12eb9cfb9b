"""The KVStore and its gradient allreduce (``mx.kv``)."""
from .kvstore import KVStore, create

__all__ = ["KVStore", "create"]
