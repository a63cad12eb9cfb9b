"""Performance, memory, model-health and tail attribution (the port of
``mxnet_tpu/profiling/``).

- :mod:`~mxnet_tpu_torch.profiling.hlo`: the port's own copy of the
  HLO text parser and analytic cost model (stdlib only), so an HLO text
  prices as the JAX package prices it;
- :mod:`~mxnet_tpu_torch.profiling.optrace`: the port's program: the
  torch ops one call dispatches, priced per op, each hand kernel one
  row with its own count, under framework op scopes that reach into the
  backward;
- :mod:`~mxnet_tpu_torch.profiling.ledger`: the cost ledger (build,
  price, attribute, summarize, diff) over either program;
- :mod:`~mxnet_tpu_torch.profiling.xplane`: the measured side: the
  Kineto trace ``torch.profiler`` exports (and a JAX ``.xplane.pb``),
  per-op self time and interval unions;
- :mod:`~mxnet_tpu_torch.profiling.capture`: the run-under-capture
  harness joining measured time onto the ledger, reconciled against
  telemetry ``mx_step_time_seconds`` (>= 90%) and, on a card, against
  CUDA events, with what the profiler lost;
- :mod:`~mxnet_tpu_torch.profiling.memory`: the liveness ledger (peak
  live bytes and the ranked buffer table), the live-tensor census with
  role tagging (per device and mesh position) and the OOM postmortem;
- :mod:`~mxnet_tpu_torch.profiling.bench_ledger`: the ``python -m``
  pass that prices ResNet-50 v1's programs on ``meta`` tensors;
- :mod:`~mxnet_tpu_torch.profiling.health`: the numerics axis: the
  nonfinite sentry at the framework seams, gradient / update-ratio
  telemetry, loss-anomaly detection, the first-NaN postmortem and drift
  fingerprints;
- :mod:`~mxnet_tpu_torch.profiling.tailpath`: per-request critical-path
  attribution over the serving span trees.

CLI: ``tools/mfu_report.py`` (table / --diff) renders the ledger and
attribution documents, ``tools/health_report.py`` and
``tools/tail_report.py`` the others.
Env: ``MXTPU_PROFILE_DIR``, ``MXTPU_PEAK_TFLOPS``, ``MXTPU_PEAK_HBM_GBS``,
``MXTPU_LEDGER_OUT``, ``MXTPU_LEDGER_STAGES``, ``MXTPU_BENCH_BATCH``,
``MXTPU_HEALTH``, ``MXTPU_HEALTH_DUMP_PATH``, ``MXTPU_HEALTH_NORMS``,
``MXTPU_HEALTH_ANOMALY_Z``, ``MXTPU_MEMORY_CENSUS``,
``MXTPU_OOM_DUMP_PATH``, ``MXTPU_TAIL_ENABLE``, ``MXTPU_TAIL_WINDOW``,
``MXTPU_TAIL_SLOW_FRAC``, ``MXTPU_TAIL_ARTIFACT``.
"""
from __future__ import annotations

from . import hlo
from . import optrace
from . import ledger
from . import xplane
from . import capture
from . import memory
from . import health
from . import tailpath
from .capture import analyze_dir, attribution_run
from .ledger import build_ledger, from_compiled, from_fn, mfu_estimate
from .memory import (build_memory_ledger, live_census, tag_role,
                     tag_tree, maybe_oom_postmortem, oom_postmortem)
from .health import (fingerprint_params, nan_postmortem,
                     localize_first_nonfinite, NonfiniteError)

__all__ = ["hlo", "ledger", "xplane", "capture", "memory", "health",
           "tailpath",
           "build_ledger", "from_compiled", "from_fn", "mfu_estimate",
           "analyze_dir", "attribution_run", "build_memory_ledger",
           "live_census", "tag_role", "tag_tree",
           "maybe_oom_postmortem", "oom_postmortem",
           "fingerprint_params", "nan_postmortem",
           "localize_first_nonfinite", "NonfiniteError"]
