"""Port parity, the paper's numpy models: the cycle model
(``repro_torch.core.simulator``), the Table-3 / Fig.-9 cost model
(``repro_torch.core.asic_model``), the telescoping-combining functions
(``repro_torch.core.telescope``) and ``activation_tile_density``, each held
to the reference. The numpy models keep the reference's order of
arithmetic, so their results are equal (``==``), not merely close."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asic_model as r_asic
from repro.core import simulator as RS
from repro.core import telescope as r_tel
from repro.core.sparse import activation_tile_density as r_tile_density
from repro_torch.core import asic_model as t_asic
from repro_torch.core import simulator as TS
from repro_torch.core import telescope as t_tel
from repro_torch.core.sparse import activation_tile_density


def test_constants_and_benchmarks_equal_reference():
    assert TS.CALIB == RS.CALIB
    assert TS.SCHEMES == RS.SCHEMES and TS.FIG7_ORDER == RS.FIG7_ORDER
    assert (TS.MACS, TS.CHUNK_BYTES, TS.SPARSE_BANKS, TS.DENSE_BANKS,
            TS.BANK_BYTES_PER_CYCLE) == \
        (RS.MACS, RS.CHUNK_BYTES, RS.SPARSE_BANKS, RS.DENSE_BANKS,
         RS.BANK_BYTES_PER_CYCLE)
    assert set(TS.BENCHMARKS) == set(RS.BENCHMARKS)
    for name, rb in RS.BENCHMARKS.items():
        tb = TS.BENCHMARKS[name]
        assert (tb.name, tb.filter_density, tb.map_density) == \
            (rb.name, rb.filter_density, rb.map_density)
        assert [dataclasses.astuple(l) for l in tb.layers] == \
            [dataclasses.astuple(l) for l in rb.layers]


@pytest.mark.parametrize("cv,entities,chunks", [
    (0.42, 1024, 1.0), (0.12, 32, 64.0), (0.42, 1, 4.0), (0.3, 2048, 0.5)])
def test_expected_max_factor_equal(cv, entities, chunks):
    assert TS._expected_max_factor(cv, entities, chunks) == \
        RS._expected_max_factor(cv, entities, chunks)


@pytest.mark.parametrize("scheme", RS.SCHEMES)
def test_simulate_every_field_equal(scheme):
    """Every ``SchemeResult`` field of every benchmark, and every layer's
    traffic and per-layer result, equals the reference's."""
    c = dict(RS.CALIB)
    for name, rb in RS.BENCHMARKS.items():
        tb = TS.BENCHMARKS[name]
        assert dataclasses.astuple(TS.simulate(tb, scheme)) == \
            dataclasses.astuple(RS.simulate(rb, scheme))
        for tl, rl in zip(tb.layers, rb.layers):
            assert TS._layer_traffic_bytes(tl, 0.3, 0.4) == \
                RS._layer_traffic_bytes(rl, 0.3, 0.4)
            assert dataclasses.astuple(TS._simulate_layer(scheme, tl, tb, c)) \
                == dataclasses.astuple(RS._simulate_layer(scheme, rl, rb, c))


def test_simulate_overrides_and_unknown_scheme():
    ov = {"noopts_refetch": 7.0, "noopts_hier": 1.0, "burst_queue_async": 1.5}
    for name in RS.FIG7_ORDER:
        assert TS.simulate(TS.BENCHMARKS[name], "BARISTA-no-opts", ov) == \
            TS.SchemeResult(**dataclasses.asdict(
                RS.simulate(RS.BENCHMARKS[name], "BARISTA-no-opts", ov)))
    r = TS.simulate(TS.BENCHMARKS["AlexNet"], "BARISTA")
    assert r.breakdown() == RS.simulate(RS.BENCHMARKS["AlexNet"],
                                        "BARISTA").breakdown()
    with pytest.raises(ValueError, match="unknown scheme"):
        TS.simulate(TS.BENCHMARKS["AlexNet"], "Sparse")


def test_tables_equal_reference():
    """Figs. 7, 10 and 11: ``speedup_table``, ``isolation_table`` and
    ``buffer_sensitivity`` (its seeded Monte Carlo too) equal the
    reference's."""
    assert TS.speedup_table() == RS.speedup_table()
    assert TS.isolation_table() == RS.isolation_table()
    assert TS.buffer_sensitivity() == RS.buffer_sensitivity()
    assert TS.buffer_sensitivity((2, 16)) == RS.buffer_sensitivity((2, 16))


def test_paper_headline_ratios():
    """The geomeans EXPERIMENTS.md records: BARISTA 5.67x Dense, 2.36x
    One-sided, 1.71x SparTen, 2.58x SparTen-Iso, within ~6% of Ideal."""
    gm = TS.speedup_table()["geomean"]
    b = gm["BARISTA"]
    assert b / gm["Dense"] == pytest.approx(5.67, abs=0.005)
    assert b / gm["One-sided"] == pytest.approx(2.36, abs=0.005)
    assert b / gm["SparTen"] == pytest.approx(1.71, abs=0.005)
    assert b / gm["SparTen-Iso"] == pytest.approx(2.58, abs=0.005)
    assert b / gm["Ideal"] > 0.92


def test_asic_model_equal_reference():
    """Table 3 and its totals, the energy constants, per-benchmark volumes
    and the Fig.-9 energy table equal the reference's."""
    assert t_asic.TABLE3 == r_asic.TABLE3
    assert t_asic.EN == r_asic.EN
    for system in r_asic.TABLE3:
        assert t_asic.totals(system) == r_asic.totals(system)
    for name, rb in RS.BENCHMARKS.items():
        assert t_asic._volumes(TS.BENCHMARKS[name], 8) == \
            r_asic._volumes(rb, 8)
    for batch in (32, 1):
        t, r = t_asic.energy_table(batch), r_asic.energy_table(batch)
        assert list(t) == list(r)
        for b in r:
            assert list(t[b]) == list(r[b])
            for s in r[b]:
                assert dataclasses.asdict(t[b][s]) == \
                    dataclasses.asdict(r[b][s])
                assert (t[b][s].compute_total, t[b][s].mem_total) == \
                    (r[b][s].compute_total, r[b][s].mem_total)
    with pytest.raises(ValueError):
        t_asic.energy(TS.BENCHMARKS["VGGNet"], "SCNN")


@pytest.mark.parametrize("seed", [0, 7])
def test_telescope_sampling_functions_equal_reference(seed):
    """``sample_arrivals``, ``snarf_fetches``, ``uncombined_fetches`` and
    ``refetch_curve`` on generators of one seed equal the reference's."""
    for n, spread in ((64, 4000.0), (16, 37.5), (1, 10.0)):
        np.testing.assert_array_equal(
            t_tel.sample_arrivals(n, spread, np.random.default_rng(seed)),
            r_tel.sample_arrivals(n, spread, np.random.default_rng(seed)))
    for p in (0.0, 0.3, 0.9):
        assert t_tel.snarf_fetches(64, p, np.random.default_rng(seed)) == \
            r_tel.snarf_fetches(64, p, np.random.default_rng(seed))
    assert t_tel.snarf_fetches(0, 0.5, np.random.default_rng(seed)) == \
        r_tel.snarf_fetches(0, 0.5, np.random.default_rng(seed))
    assert t_tel.uncombined_fetches(64, 5000.0, 40.0,
                                    np.random.default_rng(seed), trials=16) \
        == r_tel.uncombined_fetches(64, 5000.0, 40.0,
                                    np.random.default_rng(seed), trials=16)
    assert t_tel.refetch_curve(64, [1, 4, 8], 2000.0, 40.0, seed=seed,
                               trials=16) == \
        r_tel.refetch_curve(64, [1, 4, 8], 2000.0, 40.0, seed=seed,
                            trials=16)


@pytest.mark.parametrize("batch", [1, 3])
def test_combine_cross_requests_equal_reference(batch):
    """The cross-request combining model over an interleaved batch
    schedule (flush-only -1 steps included), default and explicit fetch
    windows, equals the reference's; an empty schedule too."""
    rng = np.random.default_rng(batch)
    ids = rng.integers(-1, 6, 60)
    imgs = rng.integers(0, batch, 60)
    for lat in (None, 3.0):
        assert t_tel.combine_cross_requests(ids, imgs, lat) == \
            r_tel.combine_cross_requests(ids, imgs, lat)
    empty = np.full(4, -1)
    assert t_tel.combine_cross_requests(empty, np.zeros(4)) == \
        r_tel.combine_cross_requests(empty, np.zeros(4))
    with pytest.raises(ValueError):
        t_tel.combine_cross_requests(ids, imgs[:-1])


def _tile_cases():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 200)).astype(np.float32)
    x[rng.random(x.shape) < 0.999] = 0.0
    x[:128, :128] = 0.0
    ones = np.ones((130, 128), np.float32)
    padded = np.pad(ones, ((0, 126), (0, 128)))        # the kernel's grid
    return [(np.ones((130, 70), np.float32), {}),
            (padded, {}), (padded, dict(valid_rows=130, valid_cols=128)),
            (ones, {}), (x, {}), (x, dict(block=64)),
            (x.reshape(3, 100, 200), dict(valid_rows=250)),
            (x, dict(valid_rows=10_000, valid_cols=199))]


@pytest.mark.parametrize("case", range(len(_tile_cases())))
def test_activation_tile_density_matches_reference(case):
    """Within 1e-7 of the reference's, the pre-padded case of
    ``tests/test_vision.py`` included (padding tiles past ``valid_rows`` /
    ``valid_cols`` are not counted); a 0-d float32 tensor on the input's
    device."""
    x, kw = _tile_cases()[case]
    got = activation_tile_density(torch.as_tensor(x), **kw)
    ref = float(r_tile_density(jnp.asarray(x), **kw))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - ref) <= 1e-7


def test_activation_tile_density_prepadded_values():
    padded = torch.nn.functional.pad(torch.ones(130, 128), (0, 128, 0, 126))
    assert float(activation_tile_density(padded)) == 0.5
    assert float(activation_tile_density(padded, valid_rows=130,
                                         valid_cols=128)) == 1.0
