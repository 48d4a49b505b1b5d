"""Configuration: canonical defaults and the five-tier mode preset system.

The reference exposes a uniform ``:turbo/:fast/:balanced/:accurate/:precise``
mode vocabulary across every index family, each mapping to family-specific
knobs — this is a core API surface to reproduce (SURVEY.md §5; reference
sources cited per table below). Canonical build defaults M=16, max-M0=2M,
ef-construction=200, ml=1/ln2, seed=42, metric=cosine come from
src/hnsw/ultra_fast.clj:122-135 and src/hnsw/graph.clj:68-71.
"""

from __future__ import annotations

import enum
import math


class Mode(str, enum.Enum):
    TURBO = "turbo"
    FAST = "fast"
    BALANCED = "balanced"
    ACCURATE = "accurate"
    PRECISE = "precise"

    @classmethod
    def coerce(cls, m) -> "Mode":
        if isinstance(m, Mode):
            return m
        return cls(str(m).lstrip(":").lower())


DEFAULTS = dict(
    M=16,                    # graph.clj:68 :M 16
    max_M=16,                # graph.clj:69 :max-M 16 (upper layers)
    max_M0=32,               # 2*M at layer 0 (graph.clj:214-216)
    ef_construction=200,     # graph.clj:70
    ml=1.0 / math.log(2.0),  # graph.clj:71 (level ~ floor(ml * -ln u))
    seed=42,                 # graph.clj:71, ivf_flat.clj:37, pcaf.clj:37
    metric="cosine",         # ultra_fast.clj:339 default distance = cosine
    ef_search_floor=50,      # ef = max(k, 50) (ultra_fast.clj:346-374)
)

# ef presets for graph search — pure_hnsw.clj:136-141. (In the reference the
# pure-graph path hardcodes ef=max(k,50) making these inert — graph.clj:304,
# SURVEY.md §2.9; here ef is actually honored, matching documented intent of
# wip/search_config.clj:4-25.)
HNSW_EF = {
    Mode.TURBO: 50,
    Mode.FAST: 100,
    Mode.BALANCED: 200,
    Mode.ACCURATE: 300,
    Mode.PRECISE: 500,
}

# IVF-FLAT probe counts — ivf_flat.clj:243-247.
IVF_FLAT_PROBES = {
    Mode.TURBO: 1,
    Mode.FAST: 2,
    Mode.BALANCED: 4,
    Mode.ACCURATE: 8,
    Mode.PRECISE: 12,
}

# IVF-HNSW (probes, ef) — ivf_hnsw.clj:286-290.
IVF_HNSW_MODES = {
    Mode.TURBO: (1, 50),
    Mode.FAST: (2, 100),
    Mode.BALANCED: (3, 200),
    Mode.ACCURATE: (4, 250),
    Mode.PRECISE: (5, 300),
}

# LSH (probes-per-table, multiprobe bit-flip radius) — hybrid_lsh.clj:357-362.
LSH_MODES = {
    Mode.TURBO: (2, 1),
    Mode.FAST: (3, 2),
    Mode.BALANCED: (4, 2),
    Mode.ACCURATE: (6, 3),
    Mode.PRECISE: (8, 4),
}

# PCAF k-filter (coarse candidate count multiplier base) — pcaf.clj:278-285.
PCAF_KFILTER = {
    Mode.TURBO: 16,
    Mode.FAST: 24,
    Mode.BALANCED: 32,
    Mode.ACCURATE: 48,
    Mode.PRECISE: 64,
}

# Lightning: percent of partitions scanned, keyed on partition-count bands —
# the reference's partition-count-adaptive matrix (lightning.clj:198-229).
# Bands: >=64, >=32, ==24, else.
LIGHTNING_PERCENT = {
    Mode.TURBO:    {64: 0.05, 32: 0.08, 24: 0.10, 0: 0.15},
    Mode.FAST:     {64: 0.08, 32: 0.12, 24: 0.15, 0: 0.20},
    Mode.BALANCED: {64: 0.12, 32: 0.20, 24: 0.25, 0: 0.30},
    Mode.ACCURATE: {64: 0.20, 32: 0.30, 24: 0.40, 0: 0.50},
    Mode.PRECISE:  {64: 0.40, 32: 0.60, 24: 0.75, 0: 1.00},
}


def lightning_percent(mode: Mode, num_partitions: int) -> float:
    table = LIGHTNING_PERCENT[Mode.coerce(mode)]
    for band in (64, 32, 24):
        if (band == 24 and num_partitions == 24) or (band != 24 and num_partitions >= band):
            return table[band]
    return table[0]


def adaptive_k_per_partition(num_partitions: int, k: int) -> int:
    """Per-partition k for partitioned search — partitioned_hnsw.clj:158-162:
    <=8 partitions -> 3, <=16 -> 2, <=32 -> 2, else 1 (scaled by k/10)."""
    if num_partitions <= 8:
        base = 3
    elif num_partitions <= 32:
        base = 2
    else:
        base = 1
    return max(base * max(k, 1) // 10 + 1, base) if k > 10 else base


def ef_for(mode, k: int, family: str = "hnsw") -> int:
    mode = Mode.coerce(mode)
    if family == "ivf_hnsw":
        ef = IVF_HNSW_MODES[mode][1]
    else:
        ef = HNSW_EF[mode]
    return max(ef, k)
