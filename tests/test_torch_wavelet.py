"""The port's wavelet monodepth modules against vdnerf_tpu.wavelet on the CPU.

The same numpy-seeded inputs and weights (carried by ``from_jax_variables``)
go through the flax module and its port counterpart: the Haar transforms
(within 1e-6), each encoder's five taps in eval and training mode with the
BatchNorm running statistics after the training-mode pass, every decoder's
every output key (1e-5 relative L2), and a port DenseNet's state_dict
through the JAX package's torchvision importer. The DenseNet is the small
TINY_DENSENET config (growth 8, 16 initial features, two layers a block);
DenseNet-161 itself runs on the card only.

The taps are held at 1e-5 relative L2 against JAX's, except where JAX's own
f32 tap is farther than that from the same network evaluated in f64 (the
port's module in double precision): at the deepest taps in training mode,
where flax's variance E[x^2] - E[x]^2 loses bits, MobileNetV2's /32 tap is
1.3e-4 from f64 (64^2, batch 4). There the port must be within 1.5 times
JAX's distance of the f64 tap (it is nearer: 3e-5 there). Training mode runs
at 64^2 and batch 4 for every encoder: at the /32 tap of a 32^2 batch of 2
each BatchNorm channel sees two values, which it maps to +-1 whatever their
gap, and two f32 evaluations of MobileNetV2 (JAX's and the port's, each
against f64) then differ by O(1).
"""

from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    jax_wavelet_variables,
    nchw,
    nhwc,
    one_torch_thread,
    rel_l2,
    tiny_densenet,
)
from vdnerf_tpu.wavelet import decoders as jdec
from vdnerf_tpu.wavelet import haar as jhaar
from vdnerf_tpu.wavelet.model import MonodepthModel as JaxModel
from vdnerf_tpu.wavelet.model import WaveletOpts as JaxOpts
from vdnerf_tpu_torch.wavelet import decoders as tdec
from vdnerf_tpu_torch.wavelet import haar as thaar
from vdnerf_tpu_torch.wavelet.io import from_jax_variables
from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model

TAP_TOL = 1e-5


def _hold(got, want, f64, what):
    """got (port, f32) against want (JAX) within TAP_TOL, or, where JAX's own
    f32 error against f64 (``f64()``, evaluated only then) is larger, within
    1.5 times that error of f64."""
    err = rel_l2(got, want)
    if err <= TAP_TOL:
        return
    jax_err, err64 = rel_l2(want, f64()), rel_l2(got, f64())
    assert err <= 2.5 * jax_err, (what, err, jax_err)
    assert err64 <= max(TAP_TOL, 1.5 * jax_err), (what, err64, jax_err)


def _apply(module, variables, *args, **kwargs):
    """``module.apply`` under ``jax.jit`` (quicker than op by op on the CPU)."""
    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --- Haar ---------------------------------------------------------------------


def test_haar_single_level_both_ways():
    x = _rand((2, 12, 16, 3))
    ll, highs = jhaar.haar_dwt2(jnp.asarray(x))
    tll, thighs = thaar.haar_dwt2(torch.from_numpy(nchw(x)))
    np.testing.assert_allclose(nhwc(tll), ll, atol=1e-6)
    for t, j in zip(thighs, highs):
        np.testing.assert_allclose(nhwc(t), j, atol=1e-6)

    coeffs = [_rand((2, 6, 8, 3), seed=s) for s in range(4)]
    want = jhaar.haar_idwt2(jnp.asarray(coeffs[0]), tuple(jnp.asarray(c) for c in coeffs[1:]))
    got = thaar.haar_idwt2(torch.from_numpy(nchw(coeffs[0])),
                           tuple(torch.from_numpy(nchw(c)) for c in coeffs[1:]))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)
    # the round trip is the identity
    back = thaar.haar_idwt2(tll, thighs)
    np.testing.assert_allclose(nhwc(back), x, atol=1e-6)


def test_haar_multi_level_both_ways():
    x = _rand((2, 32, 48, 1), seed=3)
    yl, highs = jhaar.haar_dwt2_multi(jnp.asarray(x), 4)
    tyl, thighs = thaar.haar_dwt2_multi(torch.from_numpy(nchw(x)), 4)
    np.testing.assert_allclose(nhwc(tyl), yl, atol=1e-6)
    assert len(thighs) == 4
    for th, jh in zip(thighs, highs):
        for t, j in zip(th, jh):
            np.testing.assert_allclose(nhwc(t), j, atol=1e-6)
    want = jhaar.haar_idwt2_multi(yl, highs)
    got = thaar.haar_idwt2_multi(tyl, thighs)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)
    np.testing.assert_allclose(nhwc(got), x, atol=1e-5)


# --- encoders -----------------------------------------------------------------


def _encoder_opts(name, tiny):
    return {"densenet": dict(encoder_type="densenet", num_layers=tiny),
            "resnet18": dict(encoder_type="resnet", num_layers=18),
            "mobilenet_light": dict(encoder_type="mobilenet_light")}[name]


def _models(kw, hw, seed=0, encoder_only=False):
    """(flax model, its seeded variables, the port model carrying them); with
    ``encoder_only`` the encoder's variables alone (any input size)."""
    jm = JaxModel(JaxOpts(**kw))
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    variables = jax_wavelet_variables(jm, x, seed=seed, train=False,
                                      **({"method": jm.encode} if encoder_only else {}))
    tm = create_model(WaveletOpts(**kw), "cpu")
    missing, unexpected = tm.load_state_dict(from_jax_variables(variables), strict=False)
    assert not unexpected and all(k.startswith("decoder.") for k in missing)
    assert encoder_only or not missing
    return jm, variables, tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["densenet", "resnet18", "mobilenet_light"])
def test_encoder_taps(tiny_densenet, name, train):
    kw = _encoder_opts(name, tiny_densenet)
    hw = (64, 64) if name == "densenet" or train else (32, 32)
    jm, variables, tm = _models(kw, hw)
    x = np.random.default_rng(1).uniform(size=(4 if train else 2, *hw, 3)).astype(np.float32)

    if train:
        taps, mutated = _apply(jm, variables, x, train=True, method=jm.encode,
                               mutable=["batch_stats"])
    else:
        taps = _apply(jm, variables, x, train=False, method=jm.encode)
    t64 = copy.deepcopy(tm).double().train(train)
    tm.train(train)
    got = tm.encode(torch.from_numpy(nchw(x)))
    f64 = []  # the f64 taps, evaluated at the first need

    def tap64(i):
        if not f64:
            f64.extend(t64.encode(torch.from_numpy(nchw(x)).double()))
        return nhwc(f64[i])

    assert len(got) == 5 and [t.shape[1] for t in got] == [t.shape[-1] for t in taps]
    for i, (g, w) in enumerate(zip(got, taps)):
        _hold(nhwc(g), w, lambda i=i: tap64(i), f"tap {i}")
    if train:
        # flax's running statistics: momentum 0.99, the biased batch variance
        want = from_jax_variables(
            {"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])})
        state = tm.state_dict()
        assert want and all(k.endswith(("running_mean", "running_var")) for k in want)
        for k, v in want.items():
            _hold(state[k], v, lambda k=k: (tap64(0), t64.state_dict()[k])[1], k)
        before = from_jax_variables({"batch_stats": variables["batch_stats"]})
        assert max(float((state[k] - v).abs().max()) for k, v in before.items()) > 1e-3


def test_densenet_channels_and_names(tiny_densenet):
    from vdnerf_tpu.wavelet.encoders import DenseEncoder as JaxDense
    from vdnerf_tpu_torch.wavelet.encoders import DenseEncoder

    for layers in (121, 161, tiny_densenet):
        assert DenseEncoder(layers).num_ch_enc == JaxDense(num_layers=layers).num_ch_enc
    names = set(DenseEncoder(tiny_densenet).state_dict())
    assert {"features.conv0.weight", "features.norm0.running_var",
            "features.denseblock2.denselayer2.conv2.weight",
            "features.transition3.norm.bias"} <= names


def test_odd_sizes_pool_as_flax(tiny_densenet):
    """The stem's -inf-padded max pool and the transitions' VALID average
    pool floor odd sizes the same way on both sides."""
    kw = _encoder_opts("densenet", tiny_densenet)
    jm, variables, tm = _models(kw, (50, 38), encoder_only=True)
    x = np.random.default_rng(2).uniform(size=(1, 50, 38, 3)).astype(np.float32)
    taps = _apply(jm, variables, x, train=False, method=jm.encode)
    got = tm.encode(torch.from_numpy(nchw(x)))
    for g, w in zip(got, taps):
        assert nhwc(g).shape == w.shape
        assert rel_l2(nhwc(g), w) <= TAP_TOL


def test_torchvision_importer_reads_the_port_densenet(tiny_densenet):
    """A port DenseEncoder's state_dict is a torchvision one: the unmodified
    ``import_torchvision_densenet`` makes JAX's encoder give the port's taps."""
    from vdnerf_tpu.wavelet.encoders import DenseEncoder as JaxDense
    from vdnerf_tpu.wavelet.io import import_torchvision_densenet

    _, _, tm = _models(_encoder_opts("densenet", tiny_densenet), (64, 64), seed=4)
    sd = tm.encoder.state_dict()
    variables = import_torchvision_densenet(sd, num_layers=tiny_densenet)
    x = np.random.default_rng(5).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    taps = _apply(JaxDense(num_layers=tiny_densenet), variables, x, train=False)
    got = tm.encode(torch.from_numpy(nchw(x)))
    for g, w in zip(got, taps):
        assert rel_l2(nhwc(g), w) <= TAP_TOL


# --- decoders -----------------------------------------------------------------

ENC = (8, 8, 16, 24, 64)


def _decoder_inputs(seed=0):
    sizes = (32, 16, 8, 4, 2)
    return [_rand((2, s, s, c), seed=seed + i) for i, (s, c) in enumerate(zip(sizes, ENC))]


def _compare_outputs(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k == "sparsity":
            assert set(got[k]) == set(want[k])
            for s in want[k]:
                np.testing.assert_allclose(float(got[k][s]), float(want[k][s]), rtol=1e-6)
            continue
        assert rel_l2(nhwc(got[k]), want[k]) <= TAP_TOL, (k, rel_l2(nhwc(got[k]), want[k]))


@pytest.mark.parametrize("name", ["DecoderWave", "DecoderWave224", "PlainDecoder",
                                  "PlainDecoder224"])
def test_decoder_outputs(name):
    jd = getattr(jdec, name)(ENC, 0.5)
    feats = _decoder_inputs()
    variables = jax_wavelet_variables(jd, [jnp.asarray(f) for f in feats], seed=6)
    want = _apply(jd, variables, feats)
    td = getattr(tdec, name)(ENC, 0.5)
    sd = from_jax_variables({"params": {"decoder": variables["params"]}})
    td.load_state_dict({k.removeprefix("decoder."): v for k, v in sd.items()})
    with torch.no_grad():
        got = td([torch.from_numpy(nchw(f)) for f in feats])
    _compare_outputs(got, want)


@pytest.mark.parametrize("padding,mode", [("reflection", "reflect"), ("replicate", "replicate")])
def test_slice_pad_is_torchs_pad(padding, mode):
    """The decoders' reflect and replicate pads by 1, built from slices (no
    atomics in the backward on the card): torch's own pad bit for bit
    forward, and its VJP within the f32 rounding of each sum (an input sums
    at most four cotangents)."""
    x = torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(8), requires_grad=True)
    got, want = tdec._pad1(x, padding), torch.nn.functional.pad(x, (1, 1, 1, 1), mode=mode)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(9))
    (dg,), (dw,) = torch.autograd.grad(got, x, g), torch.autograd.grad(want, x, g)
    torch.testing.assert_close(dg, dw, rtol=0, atol=2.0**-20 * float(g.abs().max()))


@pytest.mark.parametrize("thresh_ratio", [-1.0, 0.05, 0.2])
def test_sparse_decoder_masks_and_sparsity(thresh_ratio):
    jd = jdec.SparseDecoderWave(ENC, 0.5)
    feats = _decoder_inputs(seed=10)
    variables = jax_wavelet_variables(jd, [jnp.asarray(f) for f in feats], seed=7)
    want = jd.apply(variables, feats, thresh_ratio)  # mixed output keys: no jit
    td = tdec.SparseDecoderWave(ENC, 0.5)
    sd = from_jax_variables({"params": {"decoder": variables["params"]}})
    td.load_state_dict({k.removeprefix("decoder."): v for k, v in sd.items()})
    with torch.no_grad():
        got = td([torch.from_numpy(nchw(f)) for f in feats], thresh_ratio)
    _compare_outputs(got, want)
    if thresh_ratio > 0:
        # the masks are exact, and they do cut
        for s in (1, 0):
            np.testing.assert_array_equal(nhwc(got[("wavelet_mask", s)]),
                                          np.asarray(want[("wavelet_mask", s)]))
        assert float(got["sparsity"][0]) < 1.0


def test_model_picks_the_decoder(tiny_densenet):
    """The wrapper's choice, as the JAX model's setup makes it."""
    base = _encoder_opts("densenet", tiny_densenet)
    for kw, cls in ((dict(), tdec.DecoderWave), (dict(use_224=True), tdec.DecoderWave224),
                    (dict(use_sparse=True), tdec.SparseDecoderWave),
                    (dict(use_wavelets=False), tdec.PlainDecoder),
                    ):
        assert type(create_model(WaveletOpts(**base, **kw), "cpu").decoder) is cls
