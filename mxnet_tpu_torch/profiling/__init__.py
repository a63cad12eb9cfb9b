"""Model-health, memory and tail attribution (the port of
``mxnet_tpu/profiling/``, its first half).

- :mod:`~mxnet_tpu_torch.profiling.health`: the numerics axis: the
  nonfinite sentry at the framework seams (counts folded a few steps
  late, never waiting for the card), gradient / update-ratio telemetry,
  loss-anomaly detection, the first-NaN postmortem and drift
  fingerprints;
- :mod:`~mxnet_tpu_torch.profiling.memory`: the live-tensor census with
  role tagging (per device and mesh position) and the OOM postmortem;
- :mod:`~mxnet_tpu_torch.profiling.tailpath`: per-request critical-path
  attribution over the serving span trees.

The cost ledger and its device capture (``hlo``, ``ledger``, ``xplane``,
``capture``, ``bench_ledger``), the liveness half of ``memory`` and
``profiler.op_attribution`` wait for their design on ``torch.profiler``
(ROADMAP queue 1 item 6b-ii): the names below that belong to them raise
``NotImplementedError`` naming that item.

CLI: ``tools/health_report.py`` (table / --diff / --postmortem) and
``tools/tail_report.py`` read the documents these modules write.
Env: ``MXTPU_HEALTH``, ``MXTPU_HEALTH_DUMP_PATH``, ``MXTPU_HEALTH_NORMS``,
``MXTPU_HEALTH_ANOMALY_Z``, ``MXTPU_MEMORY_CENSUS``,
``MXTPU_OOM_DUMP_PATH``, ``MXTPU_TAIL_ENABLE``, ``MXTPU_TAIL_WINDOW``,
``MXTPU_TAIL_SLOW_FRAC``, ``MXTPU_TAIL_ARTIFACT``.
"""
from __future__ import annotations

from . import health
from . import memory
from . import tailpath
from .memory import (build_memory_ledger, live_census, tag_role,
                     tag_tree, maybe_oom_postmortem, oom_postmortem)
from .health import (fingerprint_params, nan_postmortem,
                     localize_first_nonfinite, NonfiniteError)

_PENDING = ("waits for the cost ledger's port on torch.profiler "
            "(ROADMAP queue 1 item 6b-ii)")


def _pending(name):
    def fn(*args, **kwargs):
        raise NotImplementedError("profiling.%s %s" % (name, _PENDING))
    fn.__name__ = name
    fn.__doc__ = "Raises: %s %s." % (name, _PENDING)
    return fn


analyze_dir = _pending("analyze_dir")
attribution_run = _pending("attribution_run")
build_ledger = _pending("build_ledger")
from_compiled = _pending("from_compiled")
from_fn = _pending("from_fn")
mfu_estimate = _pending("mfu_estimate")

__all__ = ["memory", "health", "tailpath",
           "build_ledger", "from_compiled", "from_fn", "mfu_estimate",
           "analyze_dir", "attribution_run", "build_memory_ledger",
           "live_census", "tag_role", "tag_tree",
           "maybe_oom_postmortem", "oom_postmortem",
           "fingerprint_params", "nan_postmortem",
           "localize_first_nonfinite", "NonfiniteError"]
