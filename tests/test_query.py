"""C10 pipeline composer vs the oracle CLI chained over files
(config 4: filter -> hash join -> hash aggregate, BASELINE.json:L10)."""

import numpy as np
import pytest

from tpq import Table, colio, datagen
from tpq.columnar import canonicalize
from tpq.query import full_pipeline, jit_pipeline

from conftest import assert_tables_equal


@pytest.mark.parametrize("algo", ["hash", "merge"])
def test_pipeline_matches_chained_oracle(oracle, tmp_path, algo):
    dim = datagen.gen_relation_np(1024, 1024, payloads=1, seed=1)
    fact = datagen.gen_relation_np(8192, 1024, payloads=2, seed=2)

    pf, pff, pd, pj, pa = (tmp_path / f"{n}.tpqc" for n in
                           ("fact", "fact_f", "dim", "join", "agg"))
    colio.dump(str(pf), fact)
    colio.dump(str(pd), dim)
    oracle("filter", **{"in": pf, "col": "key", "op": "lt", "value": 512, "out": pff})
    oracle("join", algo="hash", left=pd, right=pff, out=pj)
    oracle("aggregate", **{"in": pj, "out": pa})
    expected = colio.load(str(pa))

    out = full_pipeline(Table.from_numpy(dim), Table.from_numpy(fact),
                        "key", "lt", 512, out_capacity=1 << 14, algo=algo)
    assert_tables_equal(canonicalize(out), expected, f"pipeline_{algo}")


def test_pipeline_pushdown_equals_filter_then_join():
    """The hash path pushes the filter down into the join (`probe_keep`);
    the result equals a materialized filter followed by the join and the
    aggregate — query.py's fusion decision."""
    from tpq.ops import filter_table, hash_aggregate, hash_join

    dim = Table.from_numpy(datagen.gen_relation_np(512, 512, payloads=1, seed=7))
    fact = Table.from_numpy(datagen.gen_relation_np(4096, 512, payloads=2, seed=8))
    fused = full_pipeline(dim, fact, "key", "lt", 200, out_capacity=1 << 13,
                          algo="hash")
    staged = hash_aggregate(hash_join(dim, filter_table(fact, "key", "lt", 200),
                                      1 << 13))
    assert_tables_equal(canonicalize(fused), canonicalize(staged),
                        "pipeline_pushdown")


def test_jit_pipeline_is_one_program(oracle, tmp_path):
    """jit_pipeline returns a single jitted callable; re-invocation with a
    different filter value reuses the compilation (same shapes)."""
    dim = Table.from_numpy(datagen.gen_relation_np(512, 512, payloads=1, seed=3))
    fact = Table.from_numpy(datagen.gen_relation_np(2048, 512, payloads=1, seed=4))
    pipe = jit_pipeline(1 << 12)
    a = pipe(dim, fact, 100)
    b = pipe(dim, fact, 400)
    assert int(b.num_rows) >= int(a.num_rows)
