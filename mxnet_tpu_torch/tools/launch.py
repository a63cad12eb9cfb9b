#!/usr/bin/env python3
"""Local distributed job launcher of the PyTorch port (ref:
tools/launch.py + the dmlc-core tracker; the JAX package's own launcher,
tools/launch.py, starts that package's server).

The reference's CLI: ``launch.py -n W [-s S] command...`` starts S
parameter-server processes and W worker processes on this host, wired
by the tracker's environment: ``DMLC_ROLE``, ``DMLC_PS_ROOT_URI``,
``DMLC_PS_ROOT_PORT`` (server i listens on root + i), ``DMLC_NUM_WORKER``,
``DMLC_NUM_SERVER``, ``DMLC_WORKER_ID`` / ``DMLC_SERVER_ID``. A server runs
``mxnet_tpu_torch.kvstore.dist.run_server``; ``-s 0`` starts none, and
the workers' ``dist_device_sync`` kvstore allreduces over
``torch.distributed`` with worker 0's store at DMLC_PS_ROOT_URI:PORT.
Every process gets the repository root on ``PYTHONPATH``. Only the
``local`` launcher exists (no ssh / mpi / yarn on one host). The job's
exit code is the first failing worker's, else 0; servers and workers
still running when the job ends are stopped.

Run it as a script (``python3 mxnet_tpu_torch/tools/launch.py -n 2 -s 1
python3 train.py``): it imports neither torch nor the package.
"""
from __future__ import annotations

import argparse
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the worker preemption sentinel (the JAX package's
# checkpoint.WORKER_RESTART_EXITCODE): a worker that exits with it wrote
# its final checkpoint and asks to be started again
WORKER_RESTART_EXITCODE = 19
SERVER_MAIN = "from mxnet_tpu_torch.kvstore import dist; dist.run_server()"


def _free_port(span=1):
    """A root port with ``span`` consecutive free ports (servers bind
    root + i)."""
    for _ in range(64):
        root = random.randint(20000, 55000)
        socks = []
        try:
            for i in range(span):
                s = socket.socket()
                s.bind(("127.0.0.1", root + i))
                socks.append(s)
            return root
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range found")


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="launch a local multi-process training job of "
        "mxnet_tpu_torch")
    parser.add_argument("-n", "--num-workers", type=int, required=True)
    parser.add_argument("-s", "--num-servers", type=int, default=1,
                        help="parameter servers; keys are sharded across "
                        "them and big arrays sliced (ref: kvstore_dist.h "
                        "EncodeDefaultKey). -s 0 starts none: workers use "
                        "the collective plane (dist_device_sync) over "
                        "torch.distributed, rendezvousing at "
                        "DMLC_PS_ROOT_URI:PORT")
    parser.add_argument("--launcher", default="local", choices=["local"])
    parser.add_argument("--env-server", default="",
                        help="extra KEY=VAL,... environment for the servers "
                        "(e.g. MXNET_KVSTORE_SERVER_DEVICE=cpu)")
    parser.add_argument("--restart-policy", default="none",
                        choices=["none", "server", "worker"],
                        help="'server': a server that dies while workers "
                        "run is restarted (up to --max-server-restarts), "
                        "with MXNET_KVSTORE_SNAPSHOT_PATH wired so a "
                        "SIGTERM'd server snapshots its store and the "
                        "restart restores it. 'worker': a worker that exits "
                        f"with {WORKER_RESTART_EXITCODE} (preempted, final "
                        "checkpoint written) is started again (up to "
                        "--max-worker-restarts) with "
                        "MXNET_WORKER_CHECKPOINT_DIR wired")
    parser.add_argument("--max-server-restarts", type=int, default=3)
    parser.add_argument("--max-worker-restarts", type=int, default=3)
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")

    nserv = max(args.num_servers, 0)
    port = _free_port(span=max(nserv, 1))
    base_env = dict(os.environ)
    path = base_env.get("PYTHONPATH")
    base_env.update({
        "PYTHONPATH": ROOT + (os.pathsep + path if path else ""),
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": str(nserv),
    })

    snap_dir = None
    if args.restart_policy == "server" and nserv > 0:
        # a SIGTERM'd server writes its state here, its restart reads it
        snap_dir = tempfile.mkdtemp(prefix="mxtorch_kvsnap_")
    wk_ckpt_root = None
    own_ckpt_root = False
    if args.restart_policy == "worker":
        wk_ckpt_root = os.environ.get("MXNET_WORKER_CHECKPOINT_DIR")
        if not wk_ckpt_root:
            wk_ckpt_root = tempfile.mkdtemp(prefix="mxtorch_wkckpt_")
            own_ckpt_root = True

    def spawn_server(sidx):
        # the server runs run_server itself, after the package's import
        # has finished (no import-time entry on its updater's thread)
        env = dict(base_env, DMLC_ROLE="server", DMLC_SERVER_ID=str(sidx),
                   MXTPU_NO_SERVER_AUTOINIT="1")
        for kv in filter(None, args.env_server.split(",")):
            k, _, v = kv.partition("=")
            env[k] = v
        if snap_dir is not None:
            env.setdefault("MXNET_KVSTORE_SNAPSHOT_PATH",
                           os.path.join(snap_dir, f"server_{sidx}.snap"))
        return subprocess.Popen([sys.executable, "-c", SERVER_MAIN], env=env)

    def spawn_worker(i, restarts=0):
        env = dict(base_env, DMLC_ROLE="worker", DMLC_WORKER_ID=str(i),
                   MXNET_WORKER_RESTARTS=str(restarts))
        if wk_ckpt_root is not None:
            env["MXNET_WORKER_CHECKPOINT_DIR"] = os.path.join(
                wk_ckpt_root, f"worker_{i}")
        return subprocess.Popen(args.command, env=env)

    servers = [spawn_server(s) for s in range(nserv)]
    workers = [spawn_worker(i) for i in range(args.num_workers)]
    try:
        restarts = [0] * nserv
        wrestarts = [0] * args.num_workers
        while True:
            if args.restart_policy == "server":
                for sidx, server in enumerate(servers):
                    if server.poll() is None or server.returncode == 0 \
                            or restarts[sidx] >= args.max_server_restarts:
                        continue
                    restarts[sidx] += 1
                    print(f"launch.py: server {sidx} exited rc="
                          f"{server.returncode}, restart {restarts[sidx]}/"
                          f"{args.max_server_restarts}", file=sys.stderr,
                          flush=True)
                    servers[sidx] = spawn_server(sidx)
            elif args.restart_policy == "worker":
                for widx, worker in enumerate(workers):
                    if worker.poll() is None \
                            or worker.returncode != WORKER_RESTART_EXITCODE \
                            or wrestarts[widx] >= args.max_worker_restarts:
                        continue
                    wrestarts[widx] += 1
                    print(f"launch.py: worker {widx} preempted, restart "
                          f"{wrestarts[widx]}/{args.max_worker_restarts}",
                          file=sys.stderr, flush=True)
                    workers[widx] = spawn_worker(widx, wrestarts[widx])
            if all(w.poll() is not None for w in workers):
                break
            if any(w.returncode not in (None, 0, WORKER_RESTART_EXITCODE)
                   or (w.returncode == WORKER_RESTART_EXITCODE
                       and args.restart_policy != "worker")
                   for w in workers):
                break       # a worker failed: the job ends now
            time.sleep(0.05)
        rc = next((w.returncode for w in workers
                   if w.returncode not in (None, 0)), 0)
        if rc == 0 and any(w.poll() is None for w in workers):
            rc = 1
        for server in servers:
            if rc == 0:
                try:
                    server.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
    finally:
        _stop(workers + servers)
        if snap_dir is not None:
            shutil.rmtree(snap_dir, ignore_errors=True)
        if own_ckpt_root:
            shutil.rmtree(wk_ckpt_root, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
