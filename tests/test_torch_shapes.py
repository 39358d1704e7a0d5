"""The port's input-shape cells (`repro_torch.configs.shapes`) and the dry
run's cell arithmetic against the JAX package's: `input_specs` leaf for
leaf (path, shape and dtype) for every arch and shape, `cell_applicable`,
`microbatches_for` and `model_flops_for` equal."""

import os

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.launch.analysis import model_flops_for as jmodel_flops_for
from repro_torch import configs as TC
from repro_torch.launch.analysis import model_flops_for
from repro_torch.launch.dryrun import microbatches_for
from repro_torch.tree import flatten_with_path


def _jax_microbatches_for():
    """The JAX package's `microbatches_for`. Its module sets XLA_FLAGS when
    imported: the backend is started first (so the flag changes nothing
    here) and the variable is put back (so no child process sees it)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import microbatches_for as f
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return f


def _jleaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in flat}


def _tleaves(tree):
    return {"/".join(map(str, path)): (tuple(x.shape),
                                       str(x.dtype).replace("torch.", ""))
            for path, x in flatten_with_path(tree)}


def test_exports_match():
    assert set(TC.SHAPES) == set(JC.SHAPES)
    for k, c in TC.SHAPES.items():
        j = JC.SHAPES[k]
        assert (c.name, c.seq_len, c.global_batch, c.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
    for name in ("SHAPES", "ShapeCell", "cell_applicable", "input_specs"):
        assert name in TC.__all__


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_input_specs_leaf_for_leaf(arch):
    for reduced in (False, True):
        cfg, jcfg = (TC.get_config(arch, reduced),
                     JC.get_config(arch, reduced))
        for shape in TC.SHAPES:
            assert TC.cell_applicable(cfg, shape) == \
                JC.cell_applicable(jcfg, shape)
            for scale in (1.0, 8 / 256):
                got = TC.input_specs(cfg, shape, scale_batch=scale)
                want = JC.input_specs(jcfg, shape, scale_batch=scale)
                assert _tleaves(got) == _jleaves(want), (shape, scale)
                assert all(x.device.type == "meta"
                           for _, x in flatten_with_path(got))
            cell = TC.SHAPES[shape]
            assert TC.enc_len_for(cfg, cell) == \
                JC.enc_len_for(jcfg, JC.SHAPES[shape])


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cell_arithmetic_matches(arch):
    jmb = _jax_microbatches_for()
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    for shape, cell in TC.SHAPES.items():
        jcell = JC.SHAPES[shape]
        for n_dp in (1, 2, 16, 32):
            for gb in (None, 8, 16, 256):
                assert microbatches_for(cfg, cell, n_dp, global_batch=gb) \
                    == jmb(jcfg, jcell, n_dp, global_batch=gb)
        assert model_flops_for(cfg, cell, cfg.active_param_count()) == \
            jmodel_flops_for(jcfg, jcell, jcfg.active_param_count())
