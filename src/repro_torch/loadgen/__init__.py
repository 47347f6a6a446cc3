# Open-loop load generation: seeded arrival processes (arrival.py), the
# launch/inject/wait/harvest loop over a multi-replica Deployment
# (harness.py), and goodput/saturation metrics + BENCH payload
# rendering (metrics.py / report.py).
from .arrival import (Arrival, ArrivalProcess,  # noqa: F401
                      ConstantArrivals, DiurnalPoissonArrivals,
                      GroupedArrivals, OnOffBurstArrivals, PoissonArrivals)
from .harness import (DEFAULT_LEVELS, ElasticHarness,  # noqa: F401
                      ModelClock, OpenLoopHarness)
from .metrics import (LoadResult, find_knee,  # noqa: F401
                      latency_summary, monotone_nondecreasing, percentile,
                      ramp_ok, summarize, windowed_on_time)
from .report import headline, payload, render_table  # noqa: F401
