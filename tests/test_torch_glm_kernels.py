"""The fused GLM objective sums: the port's plain versions (what the CUDA
kernels are held against on the card) against the Pallas kernels run in
interpret mode, as tests/test_pallas_glm.py runs them; and the wrappers'
dispatch and input checks, which the CPU reaches."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.ops import cuda_build, glm_kernels, losses

PAIRS = [
    (losses.LOGISTIC, jax_losses.LOGISTIC),
    (losses.SQUARED, jax_losses.SQUARED),
    (losses.POISSON, jax_losses.POISSON),
    (losses.SMOOTHED_HINGE, jax_losses.SMOOTHED_HINGE),
]
IDS = [p[0].name for p in PAIRS]


def _problem(seed, n, d, poisson):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) * (0.1 if poisson else 1.0)
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w = (rng.normal(size=d) * 0.1).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    return X, y, off, wt, w, v


def _close_vec(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.max(np.abs(ref)) + 1e-6
    assert np.max(np.abs(got - ref)) <= tol["scale_rel"] * scale


def _close_scalar(got, ref, tol):
    np.testing.assert_allclose(float(got), float(ref), rtol=tol["rtol"], atol=tol["atol"])


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# n = 1100 is not a multiple of the Pallas row tile (ragged last tile);
# shift != 0 exercises the folded margin shift.
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_value_gradient_sums_match_pallas(pair, bf16):
    port_loss, jax_loss = pair
    X, y, off, wt, w, _ = _problem(1, 1100, 64, port_loss.name == "poisson")
    shift = 0.07
    Xj = jnp.asarray(X).astype(jnp.bfloat16) if bf16 else jnp.asarray(X)
    ref = pallas_glm.value_gradient_sums(
        jax_loss, jnp.asarray(w), jnp.float32(shift), Xj, jnp.asarray(y),
        jnp.asarray(off), jnp.asarray(wt), interpret=True,
    )
    Xt = torch.from_numpy(X).to(torch.bfloat16) if bf16 else torch.from_numpy(X)
    yt, offt, wtt, wt_ = _torch(y, off, wt, w)
    got = glm_kernels.value_gradient_sums_plain(port_loss, wt_, shift, Xt, yt, offt, wtt)
    tol = PORT_TOLERANCES["kernel_sums_bf16" if bf16 else "kernel_sums_f32"]
    _close_scalar(got[0], ref[0], tol)
    _close_vec(got[1].numpy(), ref[1], tol)
    _close_scalar(got[2], ref[2], tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("pair", PAIRS[:3], ids=IDS[:3])
def test_hessian_vector_sums_match_pallas(pair, bf16):
    port_loss, jax_loss = pair
    X, y, off, wt, w, v = _problem(2, 1100, 64, port_loss.name == "poisson")
    shift, v_shift = -0.05, 0.2
    Xj = jnp.asarray(X).astype(jnp.bfloat16) if bf16 else jnp.asarray(X)
    ref = pallas_glm.hessian_vector_sums(
        jax_loss, jnp.asarray(w), jnp.float32(shift), jnp.asarray(v), jnp.float32(v_shift),
        Xj, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt), interpret=True,
    )
    Xt = torch.from_numpy(X).to(torch.bfloat16) if bf16 else torch.from_numpy(X)
    yt, offt, wtt, wt_, vt = _torch(y, off, wt, w, v)
    got = glm_kernels.hessian_vector_sums_plain(
        port_loss, wt_, shift, vt, v_shift, Xt, yt, offt, wtt
    )
    tol = PORT_TOLERANCES["kernel_sums_bf16" if bf16 else "kernel_sums_f32"]
    _close_vec(got[0].numpy(), ref[0], tol)
    _close_scalar(got[1], ref[1], tol)


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    X, y, off, wt, w, v = _problem(3, 300, 16, False)
    Xt, yt, offt, wtt, wt_, vt = _torch(X, y, off, wt, w, v)
    before = dict(glm_kernels.LAUNCHES)
    got = glm_kernels.value_gradient_sums(losses.LOGISTIC, wt_, 0.1, Xt, yt, offt, wtt)
    ref = glm_kernels.value_gradient_sums_plain(losses.LOGISTIC, wt_, 0.1, Xt, yt, offt, wtt)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    hv = glm_kernels.hessian_vector_sums(losses.LOGISTIC, wt_, 0.1, vt, 0.0, Xt, yt, offt, wtt)
    hv_ref = glm_kernels.hessian_vector_sums_plain(
        losses.LOGISTIC, wt_, 0.1, vt, 0.0, Xt, yt, offt, wtt
    )
    assert torch.equal(hv[0], hv_ref[0]) and torch.equal(hv[1], hv_ref[1])
    # Launch counts move only where a kernel is launched.
    assert glm_kernels.LAUNCHES == before


@pytest.mark.parametrize(
    "bad",
    ["features_1d", "features_f64", "features_strided", "w_shape", "labels_f64",
     "offsets_len", "meta_device"],
)
def test_wrapper_rejects_bad_inputs(bad):
    X, y, off, wt, w, _ = _problem(4, 64, 8, False)
    args = dict(zip(["X", "y", "off", "wt", "w"], _torch(X, y, off, wt, w)))
    if bad == "features_1d":
        args["X"] = args["X"][:, 0].contiguous()
    elif bad == "features_f64":
        args["X"] = args["X"].double()
    elif bad == "features_strided":
        args["X"] = torch.from_numpy(np.asfortranarray(X))
    elif bad == "w_shape":
        args["w"] = args["w"][:5]
    elif bad == "labels_f64":
        args["y"] = args["y"].double()
    elif bad == "offsets_len":
        args["off"] = args["off"][:10]
    elif bad == "meta_device":
        args = {k: t.to("meta") for k, t in args.items()}
    with pytest.raises((ValueError, TypeError)):
        glm_kernels.value_gradient_sums(
            losses.LOGISTIC, args["w"], 0.0, args["X"], args["y"], args["off"], args["wt"]
        )


def test_library_is_named_by_its_source_and_built_under_the_package():
    path = cuda_build.library_path(glm_kernels.SOURCE)
    assert path.parent == cuda_build.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "photon_ml_tpu_torch"
    assert path.name.startswith("libglm_fused-")
    assert glm_kernels.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
