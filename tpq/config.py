"""B5 — engine + benchmark configuration (SURVEY.md §2.4 B5, §5.6).

Every BASELINE.json config (L6-L12) is a named preset here; the bench
runner (tpq/bench/runner.py) consumes these dataclasses, the CLI exposes
them by name. The reference's argv flags (reconstructed, SURVEY.md §1.1)
map onto these fields: sizes, skew theta, algorithm, partition bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class RelationSpec:
    rows: int
    nkeys: int
    payloads: int = 1
    seed: int = 0
    kind: str = "uniform"  # uniform | zipf
    theta: float = 1.0

    def capacity(self) -> int:
        from tpq.columnar import next_pow2

        return next_pow2(self.rows)


@dataclass(frozen=True)
class JoinConfig:
    """Join planning knobs."""

    algo: str = "hash"  # hash | merge
    out_capacity_factor: float = 4.0  # x max(|R|,|S|) static output slack


@dataclass(frozen=True)
class BenchConfig:
    name: str
    r: RelationSpec
    s: RelationSpec
    join: JoinConfig = field(default_factory=JoinConfig)
    pipeline: bool = False  # config 4: filter -> join -> aggregate
    filter_value: int | None = None  # pipeline filter: key < value
    warmup: int = 1
    iters: int = 5
    mesh_shape: tuple[int, ...] = ()  # () = single chip; config 5 sets this


def _c(name, **kw) -> BenchConfig:
    return BenchConfig(name=name, **kw)


# The five BASELINE.json:L6-L12 scenarios (+ small variants for smoke).
PRESETS: dict[str, BenchConfig] = {}


def _register(cfg: BenchConfig) -> BenchConfig:
    PRESETS[cfg.name] = cfg
    return cfg


# config 1 — single-chip equi-join, uniform int64, 1M x 1M, 1 payload col
_register(_c(
    "single_chip_1m",
    r=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=1),
    s=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=2),
))

# config 2 — build-side scaling sweep 10M x 100M, 4 payload cols
_register(_c(
    "build_sweep_10m_100m",
    r=RelationSpec(rows=10_000_000, nkeys=10_000_000, payloads=4, seed=1),
    s=RelationSpec(rows=100_000_000, nkeys=10_000_000, payloads=4, seed=2),
    join=JoinConfig(out_capacity_factor=2.0),
))

# config 3 — zipf theta=1.0 skew (BASELINE.json L9) on the PROBE side vs
# a uniform build. A zipf x zipf pair at these sizes joins to
# sum_k cnt_r(k)*cnt_s(k) ~ (N/ln nkeys)^2 ~ 8e9 rows — hundreds of GB
# that no engine (the reference included) could materialize, so the
# benchable reading of L9 keeps the build side uniform and puts the
# theta=1.0 skew where it stresses the engine: the probe partitions and
# the exchange.
_register(_c(
    "zipf_skew",
    r=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=1),
    s=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=2, kind="zipf"),
    join=JoinConfig(out_capacity_factor=4.0),
))

# config 4 — full pipeline: filter -> hash join -> hash aggregate, 100M fact
_register(_c(
    "pipeline_100m",
    r=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=1),  # dim
    s=RelationSpec(rows=100_000_000, nkeys=1 << 20, payloads=2, seed=2),  # fact
    pipeline=True,
    filter_value=1 << 19,
    join=JoinConfig(out_capacity_factor=1.0),
))

# config 5 — distributed join, 1B x 1B over the four cards of one host
# (all to all over NVLink, so the mesh is 1-D)
_register(_c(
    "dist_1b",
    r=RelationSpec(rows=1_000_000_000, nkeys=1_000_000_000, payloads=1, seed=1),
    s=RelationSpec(rows=1_000_000_000, nkeys=1_000_000_000, payloads=1, seed=2),
    mesh_shape=(4,),
))

# smoke-scale twins (1/1000 scale, SURVEY.md §4.5)
_register(replace(PRESETS["single_chip_1m"], name="smoke_1k",
                  r=RelationSpec(rows=1024, nkeys=1024, seed=1),
                  s=RelationSpec(rows=1024, nkeys=1024, seed=2)))
_register(replace(PRESETS["pipeline_100m"], name="smoke_pipeline",
                  r=RelationSpec(rows=1024, nkeys=1024, seed=1),
                  s=RelationSpec(rows=100_000, nkeys=1024, payloads=2, seed=2),
                  filter_value=512))
