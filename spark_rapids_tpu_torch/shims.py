"""Shim seam: version-dependent Spark semantics behind one interface.

A copy of spark_rapids_tpu/shims.py (pure Python; the port imports
nothing of the JAX package).

Role of the reference's shim system (SURVEY §2.12): 26 per-version source
trees + ShimLoader's parallel-worlds classloader let one plugin binary
serve Spark 3.1.1→4.0.0.  The engine targets one Spark line first but
keeps the seam (the survey's explicit porting guidance): every
version-dependent behavior the engine implements routes through a
`SparkShims` instance selected by `spark.rapids.tpu.spark.version`, so
adding a version is a new shim class, not edits across the engine.

Behaviors currently routed through the seam (each consumed in-engine):
- `legacy_statistical_aggregate`: Spark < 3.1.0 returns Double.NaN for
  var_samp/stddev_samp over a single row; 3.1+ returns null
  (SPARK-33726, reference GpuShimsUtils equivalents) — consumed by
  plan/aggregates.py variance family on BOTH device and CPU paths.
- `ansi_default`: spark.sql.ansi.enabled defaults false through 3.x and
  true in 4.0 preview — consumed by TpuConf.ansi when the session does
  not set the key explicitly.
- `unavailable_expressions`: expressions that do not exist in the
  pinned Spark version (e.g. SplitPart/Median arrived in 3.4) — the
  overrides engine tags them so explain output mirrors what that Spark
  version could even produce.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Tuple


class SparkShims:
    """Default = newest supported 3.x line (3.5)."""
    version_prefix = "3.5"
    legacy_statistical_aggregate = False
    ansi_default = False
    unavailable_expressions: FrozenSet[str] = frozenset()

    def describe(self) -> str:
        return f"SparkShims[{self.version_prefix}]"


class Spark30XShims(SparkShims):
    version_prefix = "3.0"
    legacy_statistical_aggregate = True
    unavailable_expressions = frozenset({"SplitPart", "Median"})


class Spark31XShims(SparkShims):
    version_prefix = "3.1"
    unavailable_expressions = frozenset({"SplitPart", "Median"})


class Spark32XShims(SparkShims):
    version_prefix = "3.2"
    unavailable_expressions = frozenset({"SplitPart", "Median"})


class Spark33XShims(SparkShims):
    version_prefix = "3.3"
    unavailable_expressions = frozenset({"SplitPart", "Median"})


class Spark34XShims(SparkShims):
    version_prefix = "3.4"


class Spark35XShims(SparkShims):
    version_prefix = "3.5"


class Spark40XShims(SparkShims):
    version_prefix = "4.0"
    ansi_default = True


_REGISTRY: Dict[str, type] = {}


def register_shim(cls: type) -> type:
    _REGISTRY[cls.version_prefix] = cls
    return cls


for _c in (Spark30XShims, Spark31XShims, Spark32XShims, Spark33XShims,
           Spark34XShims, Spark35XShims, Spark40XShims):
    register_shim(_c)

_CACHE: Dict[str, SparkShims] = {}


def get_shims(version: str) -> SparkShims:
    """Longest-prefix match, like SparkShimServiceProvider version
    detection (ShimLoader.scala:38-60)."""
    if version in _CACHE:
        return _CACHE[version]
    best: Tuple[int, type] = (-1, SparkShims)
    for prefix, cls in _REGISTRY.items():
        if version.startswith(prefix) and len(prefix) > best[0]:
            best = (len(prefix), cls)
    if best[0] < 0:
        raise ValueError(
            f"unsupported Spark version {version!r}; known lines: "
            f"{sorted(_REGISTRY)}")
    _CACHE[version] = best[1]()
    return _CACHE[version]
