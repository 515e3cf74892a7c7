"""The schema helpers and the laion config of the port against the
reference's, field by field: ``bool_col``, ``Schema.vector_columns`` and
``names``, ``Table.with_column``, ``with_valid``, ``take`` (the
``valid &`` rule) and ``to_numpy`` (with its ``__valid`` key),
``Catalog.tables``, and ``configs/chase_laion.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import chase_laion as ref_cfg
from repro.core import schema as ref_schema
from repro.data import make_laion_catalog as ref_make_catalog
from repro_torch import core as port_core
from repro_torch.configs import chase_laion as cfg
from repro_torch.core import schema
from repro_torch.core.physical import ProbeConfig
from repro_torch.data import make_laion_catalog

SMALL = dict(n_rows=300, n_queries=4, dim=8, n_modes=4, num_categories=4,
             seed=1)


@pytest.fixture(scope="module")
def catalogs():
    return ref_make_catalog(**SMALL), make_laion_catalog(**SMALL,
                                                         device="cpu")


def _same_type(got, want):
    assert got.kind.value == want.kind.value
    assert str(got.dtype).removeprefix("torch.") == np.dtype(want.dtype).name
    assert (got.dim, got.num_categories) == (want.dim, want.num_categories)
    assert got.metric.value == want.metric.value


def test_bool_col_matches_reference():
    _same_type(schema.bool_col(), ref_schema.bool_col())
    assert port_core.bool_col is schema.bool_col
    assert "bool_col" in port_core.__all__


@pytest.mark.parametrize("table", ["laion", "queries"])
def test_schema_names_and_vector_columns(catalogs, table):
    ref_cat, cat = catalogs
    ref_s, s = ref_cat.table(table).schema, cat.table(table).schema
    assert s.names() == ref_s.names()
    assert s.vector_columns() == ref_s.vector_columns()


def test_catalog_tables(catalogs):
    ref_cat, cat = catalogs
    assert cat.tables() == ref_cat.tables()
    cat2 = schema.Catalog()
    assert cat2.tables() == []


def test_with_column_and_with_valid(catalogs):
    ref_cat, cat = catalogs
    ref_t, t = ref_cat.table("laion"), cat.table("laion")
    flag = np.arange(SMALL["n_rows"]) % 2 == 0
    ref_w = ref_t.with_column("flag", ref_schema.bool_col(), flag)
    w = t.with_column("flag", schema.bool_col(), torch.from_numpy(flag))
    assert w.schema.names() == ref_w.schema.names()
    _same_type(w.schema["flag"], ref_w.schema["flag"])
    assert w.schema.primary_key == ref_w.schema.primary_key
    assert w["flag"].dtype == torch.bool and w.name == t.name
    assert "flag" not in t.schema              # the source is untouched
    valid = np.arange(SMALL["n_rows"]) % 3 != 0
    ref_v = ref_t.with_valid(valid)
    v = t.with_valid(torch.from_numpy(valid))
    np.testing.assert_array_equal(v.valid.numpy(), np.asarray(ref_v.valid))
    assert v.columns["price"] is t.columns["price"]   # columns shared


@pytest.mark.parametrize("extra", [False, True])
def test_take_follows_the_valid_rule(catalogs, extra):
    ref_cat, cat = catalogs
    n = SMALL["n_rows"]
    valid = np.arange(n) % 4 != 1
    ref_t = ref_cat.table("laion").with_valid(valid)
    t = cat.table("laion").with_valid(torch.from_numpy(valid))
    idx = np.array([5, 1, 1, 299, 0, 42, 9], np.int32)
    keep = np.array([True, True, False, True, False, True, True])
    ref_s = ref_t.take(idx, keep if extra else None)
    s = t.take(torch.from_numpy(idx), torch.from_numpy(keep) if extra
               else None)
    assert s.num_rows == ref_s.num_rows == len(idx)
    want, got = ref_s.to_numpy(), s.to_numpy()
    assert list(got) == list(want)
    assert "__valid" in got
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_to_numpy_matches_reference(catalogs):
    ref_cat, cat = catalogs
    want = ref_cat.table("queries").to_numpy()
    got = cat.table("queries").to_numpy()
    # the laion catalogs insert the vec / embedding aliases in other orders
    assert sorted(got) == sorted(want) and list(got)[-1] == "__valid"
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("make", ["bench_config", "smoke_bench_config"])
def test_chase_bench_config_matches_reference(make):
    got, want = getattr(cfg, make)(), getattr(ref_cfg, make)()
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if name == "metric":
            assert g.value == w.value
        elif name == "probe":
            assert isinstance(g, ProbeConfig)
            assert dataclasses.asdict(g) == dataclasses.asdict(w), make
        else:
            assert g == w, (make, name)


def test_configs_package_exports_only_chase_laion():
    """The package exports what the reference's does (the ``--arch``
    registry beside ``chase_laion``), and ``chase_laion`` is the module."""
    import repro.configs as ref_configs
    import repro_torch.configs as configs
    assert configs.__all__ == ref_configs.__all__
    assert "chase_laion" in configs.__all__
    assert configs.chase_laion is cfg
