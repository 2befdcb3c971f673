"""Port parity, pruning and instrumentation: ``prune_masks`` (per-filter
magnitude masks, ``min_size`` held against the reference's leaf stacked
over periods), ``apply_masks``, ``mask_gradients``, ``density_report``,
the fixed-mask train step, and the activation-density probes of
``repro_torch`` against the JAX reference on the same weights."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.data import pipeline as r_data
from repro.models import model as RM
from repro.sparsity import instrument as r_inst
from repro.sparsity import pruning as r_pruning
from repro_torch.configs import base as t_base
from repro_torch.convert import STACKS, params_from_reference
from repro_torch.data.pipeline import batch_for
from repro_torch.optim import adamw
from repro_torch.sparsity import instrument as t_inst
from repro_torch.sparsity import pruning as t_pruning
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.tree import map_tree, map_tree_with_path

CPU = torch.device("cpu")
MOE = "moonshot_v1_16b_a3b"


def ref_leaf(tree, path):
    if path[0] in STACKS:
        t = tree[path[0]]
        for k in path[2:]:
            t = t[k]
        return None if t is None else np.asarray(t)[path[1]]
    for k in path:
        tree = tree[k]
    return None if tree is None else np.asarray(tree)


@functools.lru_cache(maxsize=None)
def models(arch):
    rc, tc = r_base.load_smoke(arch), t_base.load_smoke(arch)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   rc)
    return rc, tc, rp, params_from_reference(jax.tree.map(np.asarray, rp),
                                             device=CPU)


def masks_equal(tm, rm):
    """Every port mask equals the reference's period slice; ``None``
    exactly where the reference has ``None``. Returns the pruned count."""
    n = 0

    def check(path, m):
        nonlocal n
        r = ref_leaf(rm, path)
        assert (m is None) == (r is None), path
        if m is not None:
            assert m.dtype == torch.float32
            np.testing.assert_array_equal(m.numpy(), r)
            n += 1
    map_tree_with_path(check, tm)
    return n


@pytest.mark.parametrize("arch,pc", [
    ("qwen3_4b", dict(density=0.5, min_size=512)),
    ("qwen3_4b", dict(density=0.35)),
    (MOE, dict(density=0.35, min_size=512)),        # 3-D expert banks
    (MOE, dict(density=0.4, names=("w_out",))),
])
def test_prune_masks_equal_reference(arch, pc):
    _, _, rp, tp = models(arch)
    rm = r_pruning.prune_masks(rp, r_pruning.PruneConfig(**pc))
    tm = t_pruning.prune_masks(tp, t_pruning.PruneConfig(**pc))
    assert masks_equal(tm, rm) > 0


def test_prune_masks_min_size_counts_the_stacked_leaf():
    """A per-period leaf of 8192 under a 2-period stack is 16384 to the
    reference: ``min_size`` between the two prunes it in both packages,
    above both prunes it in neither."""
    _, tc, rp, tp = models("qwen3_4b")
    w = tp["blocks"][0]["p0"]["ffn"]["w_in"]
    assert w.numel() == 8192 and len(tp["blocks"]) == 2
    for min_size, pruned in ((10_000, True), (16_384, True),
                             (16_385, False)):
        rm = r_pruning.prune_masks(rp, r_pruning.PruneConfig(
            min_size=min_size))
        tm = t_pruning.prune_masks(tp, t_pruning.PruneConfig(
            min_size=min_size))
        assert (masks_equal(tm, rm) > 0) == pruned, min_size


@pytest.mark.parametrize("arch", ["qwen3_4b", MOE])
def test_apply_masks_mask_gradients_and_report_equal_reference(arch):
    rc, tc, rp, tp = models(arch)
    pc = dict(density=0.5, min_size=512)
    rm = r_pruning.prune_masks(rp, r_pruning.PruneConfig(**pc))
    tm = t_pruning.prune_masks(tp, t_pruning.PruneConfig(**pc))
    rpm = r_pruning.apply_masks(rp, rm)
    tpm = t_pruning.apply_masks(tp, tm)
    map_tree_with_path(lambda p, x: np.testing.assert_array_equal(
        x.numpy(), ref_leaf(rpm, p)), tpm)
    # the port's gradients: zero where pruned, untouched elsewhere
    batch = batch_for(tc, t_base.ShapeConfig("t", 16, 2, "train"), 0,
                      device=CPU)
    _, _, g = loss_and_grads(tp, batch, tc)
    tg = t_pruning.mask_gradients(g, tm)
    map_tree_with_path(
        lambda path, x, g0, m: None if x is None else
        torch.testing.assert_close(x, g0 if m is None else g0 * m,
                                   rtol=0, atol=0), tg, g, tm)
    if "expert_perm" in tp:
        assert tg["expert_perm"] is None
    # masking alike: the masks applied to all-ones gradients in both
    rg = r_pruning.mask_gradients(jax.tree.map(jnp.ones_like, rp), rm)
    ones = map_tree(lambda p: torch.ones_like(p)
                    if p.is_floating_point() else None, tp)
    map_tree_with_path(lambda p, x: None if x is None else
                       np.testing.assert_array_equal(
                             x.numpy(), ref_leaf(rg, p)),
                       t_pruning.mask_gradients(ones, tm))
    # one density per period of each reference leaf, equal to its slice's
    rep = t_pruning.density_report(tp, tm)
    rrep = r_pruning.density_report(rp, rm)
    assert len(rep) == len(rrep) * len(tp["blocks"])
    for key, dens in rep.items():
        path = tuple(int(s) if s.isdigit() else s for s in key.split("/"))
        assert "/".join([key.split("/")[0]] + key.split("/")[2:]) in rrep
        assert dens == pytest.approx(float(ref_leaf(rm, path).mean()),
                                     abs=1e-7)


def test_pruned_training_keeps_zeros():
    """Fixed-mask fine-tuning: 3 steps, every pruned position stays
    exactly zero, and the unpruned positions moved."""
    _, tc, _, tp = models("qwen3_4b")
    masks = t_pruning.prune_masks(tp, t_pruning.PruneConfig(density=0.5,
                                                            min_size=512))
    params = t_pruning.apply_masks(tp, masks)
    step = t_pruning.make_pruned_train_step(
        make_train_step(tc, adamw.AdamWConfig(warmup_steps=0)), masks)
    opt = adamw.init(params)
    shape = t_base.ShapeConfig("t", 32, 4, "train")
    start = params
    for i in range(3):
        params, opt, m = step(params, opt, batch_for(tc, shape, i,
                                                     device=CPU))
    checked = 0

    def check(path, p, p0, mk):
        nonlocal checked
        if mk is None:
            return
        assert torch.all(p[mk == 0] == 0), path
        assert not torch.equal(p[mk == 1], p0[mk == 1]), path
        checked += 1
    map_tree_with_path(check, params, start, masks)
    assert checked == 6 and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("shape", [(2, 64, 256), (3, 5, 200), (130, 384)])
def test_instrument_densities_equal_reference(rng, shape):
    x = np.maximum(rng.normal(size=shape), 0).astype(np.float32)
    x[..., :128] *= rng.random(shape[:-1] + (1,)) < 0.3   # dead chunks
    rx, tx = jnp.asarray(x), torch.from_numpy(x)
    rp, tp = r_inst.ffn_sparsity_probe(rx), t_inst.ffn_sparsity_probe(tx)
    assert set(rp) == set(tp)
    for k in rp:
        assert float(tp[k]) == pytest.approx(float(rp[k]), abs=1e-7), k
    assert float(t_inst.tile_density(tx)) >= float(t_inst.scalar_density(tx))
    for bm, bk in ((8, 64), (128, 128)):
        assert float(t_inst.tile_density(tx, bm, bk)) == pytest.approx(
            float(r_inst.tile_density(rx, bm, bk)), abs=1e-7)
    assert float(t_inst.effective_flop_fraction(tx, 0.4)) == pytest.approx(
        float(r_inst.effective_flop_fraction(rx, 0.4)), abs=1e-7)
