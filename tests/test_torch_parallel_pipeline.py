"""GPipe over 2 gloo ranks on the CPU: ``pipeline_apply`` (forward and
grads) against the sequential stages and against the JAX package's on a
2-device mesh; ``pipeline_swin_stage`` (a Swin stage's block pairs split
over the ranks) against the JAX one and the blocks run in order, with
JAX's errors for stages and batches that do not divide."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from fmc_uia_tpu.models.encoders.swin import SwinEncoder as JaxSwin
from fmc_uia_tpu.parallel.pipeline import pipeline_apply as jpipe
from fmc_uia_tpu.parallel.pipeline import pipeline_swin_stage as jswin
from fmc_uia_tpu_torch.parallel import run_local
from fmc_uia_tpu_torch.utils.convert import jax_leaves_to_port
from test_torch_parallel_workers import SWIN_KW, run_jobs
from torch_port_utils import random_like_tree

S, M = 2, 4
DEADLINE = 180


def _arrays():
    rng = np.random.RandomState(0)
    F = 8
    return {"w": (rng.standard_normal((S, F, F)) / np.sqrt(F)).astype(
        np.float32),
            "b": (0.1 * rng.standard_normal((S, F))).astype(np.float32),
            "x": rng.standard_normal((M, 3, F)).astype(np.float32),
            "cot": rng.standard_normal((M, 3, F)).astype(np.float32)}


def _jax_swin():
    enc = JaxSwin(scan_stages=[2], fused_block=False, fused_mlp=False,
                  **SWIN_KW)
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(3),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    params = random_like_tree(shapes, seed=4)
    rng = np.random.RandomState(1)
    x = rng.standard_normal((4, 8, 8, 64)).astype(np.float32)
    cot = rng.standard_normal((4, 8, 8, 64)).astype(np.float32)
    return enc, params, x, cot


@pytest.fixture(scope="module")
def runs():
    a = _arrays()
    enc, params, x, cot = _jax_swin()
    swin = {"params": jax_leaves_to_port(params), "x": x, "cot": cot,
            "M": 2}
    res = run_local(run_jobs, S, args=([("pipe", dict(arrays=a,
                                                      swin=swin))],),
                    timeout_s=DEADLINE)
    return dict(a=a, enc=enc, params=params, x=x, cot=cot,
                res=[r[0] for r in res])


def _close(got, want, rel=1e-5, what=""):
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def test_pipeline_apply_matches_sequential(runs):
    for r in runs["res"]:
        _close(r["apply"]["y"], r["apply"]["seq"], what="y")


def test_pipeline_apply_matches_jax(runs):
    """Output replicated on every rank; the grads of the stacked params
    (whole on every rank) and of the input, as JAX's."""
    a = runs["a"]
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("pipe",))

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def loss(p, x):
        return jnp.sum(jpipe(stage_fn, p, x, mesh) * a["cot"])

    p = {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}
    y = np.asarray(jpipe(stage_fn, p, jnp.asarray(a["x"]), mesh))
    gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(a["x"]))
    for r in runs["res"]:
        _close(r["apply"]["y"], y, what="y")
        _close(r["apply"]["dx"], np.asarray(gx), what="dx")
        _close(r["apply"]["dw"], np.asarray(gp["w"]), what="dw")
        _close(r["apply"]["db"], np.asarray(gp["b"]), what="db")


def test_pipeline_swin_stage_matches_jax_and_sequential(runs):
    """Stage 2 (4 blocks, 2 pairs: one pair a rank), 2 microbatches: the
    output equals the JAX pipeline's on a 2-device mesh and the blocks
    run in order; the input grad and every block's grads (each on the
    rank that runs it) equal JAX's."""
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("pipe",))
    enc, params, x, cot = runs["enc"], runs["params"], runs["x"], runs["cot"]

    def loss(stage, xx):
        p = dict(params, stage2_scan=stage)
        out = jswin(enc, p, 2, xx, mesh, 2)
        return jnp.sum(out * cot), out

    (_, want), (gstage, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params["stage2_scan"],
                                             jnp.asarray(x))
    want = np.asarray(want)
    gwant = jax_leaves_to_port({"stage2_scan": jax.tree_util.tree_map(
        np.asarray, gstage)})
    got_grads = {}
    for rank, r in enumerate(runs["res"]):
        _close(r["swin"]["y"], want, what="y")
        _close(r["swin"]["seq"], want, what="sequential")
        _close(r["swin"]["dx"], np.asarray(gx), rel=1e-4, what="dx")
        mine = {n for n in r["swin"]["grads"] if n.startswith("stage2_")}
        assert {n.split(".")[0] for n in mine} == {
            f"stage2_block{2 * rank}", f"stage2_block{2 * rank + 1}"}
        got_grads.update({n: r["swin"]["grads"][n] for n in mine})
    assert set(got_grads) == set(gwant)
    for n, v in gwant.items():
        _close(got_grads[n], v, rel=1e-4, what=n)


def test_pipeline_swin_stage_errors(runs):
    """A stage whose pairs do not divide over the pipe axis, and a batch
    that does not divide into the microbatches, raise JAX's errors."""
    errors = runs["res"][0]["errors"]
    assert errors[0] == "n_pairs 3 must divide over pipe axis size 2"
    assert errors[1] == "batch 4 must divide into 3 microbatches"
