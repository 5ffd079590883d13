"""The port's camera math (``vdnerf_tpu_torch/utils/so3.py``,
``vdnerf_tpu_torch/data/cameras.py``, the multistep schedules) against
vdnerf_tpu on numpy-seeded inputs.

Tolerances:

- ``so3_exp``, ``make_c2w``, the quaternion conversions and ``slerp``: values
  within 1e-6 (f32 elementwise math in another order); ``so3_exp``'s VJP
  within 1e-6 at r = 0 (where the learned deltas start, so the first step's
  gradient comes from the small-angle branch), at |r| < 1e-4 and at random r;
- the f32 error of ``so3_exp``'s VJP against f64 (random cotangents, |r| from
  1e-5 to 0.1): the port's within 1.5x JAX's plus 1e-7. It reaches ~6e-5
  at |r| ~ 1e-4 on both sides, the cancellation in 1 - cos just past the
  small-angle branch's threshold (|r|^2 < 1e-8): a property of the formula
  the port copies, which the learned-camera trajectory test meets;
- ``umeyama`` (numpy f64 in both): equal to 1e-12;
- ``learn_intrin_K`` at focal orders 1 and 2, its closed-form inverse
  against ``jnp.linalg.inv`` and the inverse's derivative in ``fx``: 1e-6
  relative (LU against the closed form);
- learned rays against JAX's ``rays_from_batch`` with ``learnable=True``:
  values and the VJP with respect to r, t and fx, 1e-6 relative;
- the pose and focal schedules at every milestone and its neighbours: exact
  in f32; ``init_focal_params`` and ``perturb_poses`` (same numpy seed):
  exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from vdnerf_tpu.data import cameras as jc
from vdnerf_tpu.train import schedules as js
from vdnerf_tpu.train.step import SceneStatic
from vdnerf_tpu.train.step import rays_from_batch as jax_rays_from_batch
from vdnerf_tpu.utils import so3 as jso3
from vdnerf_tpu_torch.data import cameras as tc
from vdnerf_tpu_torch.train import schedules as ts
from vdnerf_tpu_torch.train.step import rays_from_batch
from vdnerf_tpu_torch.utils import so3 as tso3

H, W, N_CAMS = 30, 40, 5


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rotvecs(case: str, rng) -> np.ndarray:
    if case == "zero":
        return np.zeros((4, 3), np.float32)
    if case == "tiny":
        v = rng.normal(size=(4, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)
                * rng.uniform(1e-6, 1e-4, size=(4, 1))).astype(np.float32)
    return rng.normal(scale=0.8, size=(4, 3)).astype(np.float32)


@pytest.mark.parametrize("case", ["zero", "tiny", "random"])
def test_so3_exp_and_its_vjp_match_jax(case):
    rng = np.random.default_rng({"zero": 0, "tiny": 1, "random": 2}[case])
    r = _rotvecs(case, rng)
    g = rng.normal(size=(4, 3, 3)).astype(np.float32)
    want, vjp = jax.vjp(jso3.so3_exp, jnp.asarray(r))
    (want_grad,) = vjp(jnp.asarray(g))
    rt = torch.tensor(r, requires_grad=True)
    got = tso3.so3_exp(rt)
    (got_grad,) = torch.autograd.grad(got, rt, torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert np.isfinite(got_grad.numpy()).all()
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scale", [1e-5, 1e-4, 1e-3, 1e-2, 1e-1])
def test_so3_exp_vjp_f32_error_is_the_references(scale):
    rng = np.random.default_rng(int(-np.log10(scale)))
    r = (rng.normal(size=(64, 3)) * scale).astype(np.float32)
    g = rng.normal(size=(64, 3, 3)).astype(np.float32)
    _, vjp = jax.vjp(jso3.so3_exp, jnp.asarray(r))
    (want,) = vjp(jnp.asarray(g))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        rt = torch.tensor(r, dtype=dtype, requires_grad=True)
        (grads[dtype],) = torch.autograd.grad(tso3.so3_exp(rt), rt, torch.tensor(g, dtype=dtype))
    truth = grads[torch.float64].numpy()

    def err(x):
        return float(np.linalg.norm(np.asarray(x, np.float64) - truth) / np.linalg.norm(truth))

    port, ref = err(grads[torch.float32].numpy()), err(want)
    print(f"\n|r| ~ {scale:.0e}: so3_exp VJP f32 vs f64, JAX {ref:.2e}, port {port:.2e}")
    assert port <= 1.5 * ref + 1e-7


def test_make_c2w_matches_jax():
    rng = np.random.default_rng(3)
    r = rng.normal(scale=0.5, size=(6, 3)).astype(np.float32)
    r[0] = 0.0
    t = rng.normal(size=(6, 3)).astype(np.float32)
    want = np.asarray(jso3.make_c2w(jnp.asarray(r), jnp.asarray(t)))
    got = tso3.make_c2w(torch.tensor(r), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[:, 3] == [0, 0, 0, 1]).all()


def test_quaternions_and_slerp_match_jax():
    rng = np.random.default_rng(4)
    # rotations of every Shepperd branch: small, and near pi about each axis
    r = np.concatenate([rng.normal(scale=0.3, size=(4, 3)),
                        np.eye(3) * 3.0, rng.normal(scale=2.0, size=(5, 3))]).astype(np.float32)
    R = np.asarray(jso3.so3_exp(jnp.asarray(r)))
    q_want = np.asarray(jso3.mat_to_quat(jnp.asarray(R)))
    q_got = tso3.mat_to_quat(torch.tensor(R)).numpy()
    np.testing.assert_allclose(q_got, q_want, atol=1e-6, rtol=0)
    # round trip back to the matrices
    back = tso3.quat_to_mat(torch.tensor(q_got)).numpy()
    np.testing.assert_allclose(back, np.asarray(jso3.quat_to_mat(jnp.asarray(q_want))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(back, R, atol=1e-5, rtol=0)
    R0, R1 = R[:6], R[6:]
    for ratio in (0.0, 0.3, 0.5, 1.0):
        want = np.asarray(jso3.slerp(jnp.asarray(R0), jnp.asarray(R1), ratio))
        got = tso3.slerp(torch.tensor(R0), torch.tensor(R1), ratio).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # identical rotations take the linear branch
    same = tso3.slerp(torch.tensor(R0), torch.tensor(R0), 0.4).numpy()
    np.testing.assert_allclose(same, np.asarray(jso3.slerp(jnp.asarray(R0), jnp.asarray(R0), 0.4)),
                               atol=1e-6, rtol=0)


def test_umeyama_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(8, 3))
    R = np.asarray(jso3.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32))), np.float64)
    dst = 1.7 * src @ R.T + rng.normal(size=3) + rng.normal(scale=1e-3, size=(8, 3))
    s, R_got, t = tso3.umeyama(src, dst)
    s_w, R_w, t_w = jso3.umeyama(src, dst)
    assert abs(s - s_w) <= 1e-12
    np.testing.assert_allclose(R_got, R_w, atol=1e-12, rtol=0)
    np.testing.assert_allclose(t, t_w, atol=1e-12, rtol=0)
    assert abs(s - 1.7) < 1e-2


@pytest.mark.parametrize("order", [1, 2])
def test_learned_intrinsics_match_jax(order):
    focal = 37.3
    fx = tc.init_focal_params(focal, W, order)
    want_fx = float(jc.init_focal_params(focal, W, order)["fx"])
    assert fx == want_fx
    assert tc.init_focal_params(None, W, order) == float(jc.init_focal_params(None, W)["fx"])

    def jax_inv(f):
        return jnp.linalg.inv(jc.learn_intrin_K({"fx": f}, H, W, order))

    f = jnp.asarray(want_fx, jnp.float32)
    np.testing.assert_array_equal(
        tc.learn_intrin_K(torch.tensor(fx), H, W, order).numpy(),
        np.asarray(jc.learn_intrin_K({"fx": f}, H, W, order)))
    g = np.random.default_rng(6).normal(size=(4, 4)).astype(np.float32)
    want, vjp = jax.vjp(jax_inv, f)
    (want_dfx,) = vjp(jnp.asarray(g))
    ft = torch.tensor(fx, requires_grad=True)
    got = tc.learn_intrin_K_inv(ft, H, W, order)
    (got_dfx,) = torch.autograd.grad(got, ft, torch.tensor(g))
    assert _rel_err(got.detach().numpy(), want) <= 1e-6
    assert _rel_err(got_dfx.numpy(), want_dfx) <= 1e-6
    # and the module's K inverse is the function's
    cams = tc.LearnedCameras(np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)), focal, H, W, order)
    assert float(cams.fx.detach()) == want_fx
    np.testing.assert_array_equal(cams.K_inv().detach().numpy(), got.detach().numpy())


def _learned_state(rng):
    init = np.asarray(jc.perturb_poses(np.tile(np.eye(4, dtype=np.float32), (N_CAMS, 1, 1)),
                                       rng, 0.3, 0.5))
    init[:, 2, 3] -= 3.0
    r = rng.normal(scale=0.05, size=(N_CAMS, 3)).astype(np.float32)
    t = rng.normal(scale=0.05, size=(N_CAMS, 3)).astype(np.float32)
    r[1] = 0.0  # a camera at its initial pose: the small-angle branch
    return init, r, t, float(jc.init_focal_params(45.0, W)["fx"])


@pytest.mark.parametrize("cam", [1, 3])
def test_learned_rays_and_their_vjp_match_jax(cam):
    rng = np.random.default_rng(10 + cam)
    init, r, t, fx = _learned_state(rng)
    batch = {"img_idx": np.int32(cam),
             "pixels_x": rng.integers(0, W, size=64).astype(np.int32),
             "pixels_y": rng.integers(0, H, size=64).astype(np.int32)}
    g_o, g_d = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    scene = SceneStatic(H=H, W=W, learnable=True)

    def jax_rays(pose, focal):
        return jax_rays_from_batch(scene, {"pose": pose, "focal": focal,
                                           "init_c2w": jnp.asarray(init)}, batch)

    (o_w, d_w), vjp = jax.vjp(jax_rays, {"r": jnp.asarray(r), "t": jnp.asarray(t)},
                              {"fx": jnp.asarray(fx, jnp.float32)})
    g_pose, g_focal = vjp((jnp.asarray(g_o), jnp.asarray(g_d)))

    cams = tc.LearnedCameras(init, None, H, W)
    cams.load_state_dict({"r": torch.tensor(r), "t": torch.tensor(t),
                          "fx": torch.tensor(fx), "init_c2w": torch.tensor(init)})
    o, d = rays_from_batch(cams, batch, "cpu")
    torch.autograd.backward([o, d], [torch.tensor(g_o), torch.tensor(g_d)])
    assert _rel_err(o.detach().numpy(), o_w) <= 1e-6
    assert _rel_err(d.detach().numpy(), d_w) <= 1e-6
    for got, want in ((cams.r.grad, g_pose["r"]), (cams.t.grad, g_pose["t"]),
                      (cams.fx.grad, g_focal["fx"])):
        assert _rel_err(got.numpy(), want) <= 1e-6
    # the gradient is dense, zero for the cameras not in the batch
    others = [i for i in range(N_CAMS) if i != cam]
    assert not cams.r.grad[others].any() and cams.r.grad[cam].any()
    # every camera's learned c2w at once equals the per-camera pick
    np.testing.assert_array_equal(cams.all_c2w()[cam].detach().numpy(),
                                  cams.c2w(torch.tensor([cam]))[0].detach().numpy())
    np.testing.assert_allclose(
        cams.all_c2w().detach().numpy(),
        np.asarray(jc.all_learned_c2w({"r": jnp.asarray(r), "t": jnp.asarray(t)},
                                      jnp.asarray(init))), atol=1e-6, rtol=0)


SCHEDULES = [
    ("pose", 5000, 300000, 5000, 5e-4, 0.9),
    ("focal", 5000, 300000, 5000, 5e-4, 0.9),
    ("pose", 200, 1000, 100, 1e-3, 0.9),
    ("focal", 200, 1000, 100, 1e-3, 0.9),
]


@pytest.mark.parametrize("which,warm_up_end,end_iter,step_size,lr,gamma", SCHEDULES)
def test_multistep_schedules_match_jax(which, warm_up_end, end_iter, step_size, lr, gamma):
    ms_j = getattr(js, f"{which}_lr_milestones")(warm_up_end, end_iter, step_size)
    ms_t = getattr(ts, f"{which}_lr_milestones")(warm_up_end, end_iter, step_size)
    assert ms_t == ms_j
    want = jax.jit(js.multistep_schedule(lr, ms_j, gamma))
    got = ts.multistep_schedule(lr, ms_t, gamma)
    steps = sorted({0, *(m + d for m in ms_j for d in (-1, 0, 1))})
    assert all(np.float32(got(s)) == np.float32(want(s)) for s in steps)
    if which == "focal" and step_size == warm_up_end:
        # the reference's literal tuple: at step_size == warm_up_end two of
        # its milestones fall on one step, and the rate drops by gamma^2 there
        assert got(warm_up_end) == ts.multistep_schedule(lr, (0, 0), gamma)(0)
        assert got(warm_up_end - 1) == np.float32(lr)


def test_perturb_poses_matches_jax():
    poses = np.asarray(jc.perturb_poses(np.tile(np.eye(4, dtype=np.float32), (6, 1, 1)),
                                        np.random.default_rng(0), 0.5, 1.0))
    want = jc.perturb_poses(poses, np.random.default_rng(5))
    got = tc.perturb_poses(poses, np.random.default_rng(5))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - poses).max() > 1e-3
