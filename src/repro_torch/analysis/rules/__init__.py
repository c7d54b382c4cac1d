"""Rule modules self-register on import (see ``core.all_rules``)."""
from repro_torch.analysis.rules import (  # noqa: F401
    bench_parity,
    cache_aliasing,
    hygiene,
    recompile_hazard,
    trace_host_sync,
    x64_discipline,
)
