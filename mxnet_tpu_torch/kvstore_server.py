"""Parameter-server entry point (the port of
``mxnet_tpu/kvstore_server.py``; ref: python/mxnet/kvstore_server.py).

The server loop lives in :func:`.kvstore.dist.run_server` over the native
transport. This module keeps the reference's import-level contract: a
process in the server role (``DMLC_ROLE=server`` with the launcher's
``DMLC_PS_ROOT_PORT``) that imports the package enters the server loop
at import and exits when it ends, never returning to user code (ref:
python/mxnet/kvstore_server.py:90), so a tracker's server command may be
any script that imports the package. ``MXTPU_NO_SERVER_AUTOINIT=1``
imports the package in a server-role process without entering the loop.
"""
from __future__ import annotations

import os
import sys


def _init_kvstore_server_module():
    """Enter the server loop when this process holds the server role,
    then exit the process (ref: kvstore_server.py
    _init_kvstore_server_module)."""
    if os.environ.get("DMLC_ROLE", "") == "server":
        from .kvstore import dist
        dist.run_server()
        sys.exit()


if (os.environ.get("DMLC_ROLE") == "server"
        and os.environ.get("DMLC_PS_ROOT_PORT")
        and not os.environ.get("MXTPU_NO_SERVER_AUTOINIT")):
    # gated on the tracker's environment, so a stray DMLC_ROLE cannot
    # hang an import
    _init_kvstore_server_module()
