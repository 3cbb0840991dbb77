"""The port's mesh layer in one process (jpeg_decoder_tpu_torch.parallel.mesh
and multihost without a process group; device="cpu", the kernels' plain
versions) against the port without a mesh and against the JAX package.

- make_mesh without a process group is the 1 x 1 mesh over this process,
  and a 1 x 1 mesh is bitwise no mesh for BatchDecoder's decode_batch,
  decode_stream and decode_many and for decode_striped (nearest-neighbour
  and fancy; NATIVE, whose stripes decode their own restart segments, and
  PALLAS, sliced from the whole image); the JAX package's decode_batch and
  decode_striped over its own 1 x 1 mesh give the same bytes.
- The port's halo function over a list of stripe planes is bitwise the JAX
  _halo_exchange_rows under shard_map on the 8-device CPU mesh that
  tests/conftest.py forces.
- A stripe decoded alone (StripeStage.stripe, a rank's share) with its
  neighbours' edge rows: its kernel route (K0/K1, then K6h's wrapper with
  the halo rows, run here as the plain versions) bitwise its plain route
  (the JAX program's stripe) and, stripe by stripe, bitwise the one-process
  StripeStage; entropy_decode_stripe bitwise the one-process stripes.
- dryrun_multichip(1) without a group: its RGB within 1 of the JAX dry
  run's step (FLOAT32: the JAX stripes' IDCT is idct_matmul) and bitwise
  the port's whole-frame decode; its coefficients bitwise the JAX
  fdct_quantize(plane_to_blocks(.)) of the port's RGB.

Tolerances: EXACT RGB bitwise; FLOAT32 within 1 of the JAX package (as in
tests/test_torch_stripes.py). The multi-process runs are in
tests/test_torch_multihost.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import jpeg_decoder_tpu as jt
from jpeg_decoder_tpu.models import encoder as jencoder
from jpeg_decoder_tpu.ops import fdct as jfdct
from jpeg_decoder_tpu.parallel import batch as jbatch
from jpeg_decoder_tpu.parallel import mesh as jmesh
from jpeg_decoder_tpu.parallel import stripes as jstripes
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu_torch import DecodeConfig, EntropyBackend, IdctPrecision, Quirks
from jpeg_decoder_tpu_torch.benchmarks.inputs import make_jpeg
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.ops import color as tcolor
from jpeg_decoder_tpu_torch.parallel import mesh as tmesh
from jpeg_decoder_tpu_torch.parallel import multihost
from jpeg_decoder_tpu_torch.parallel import stripes as tstripes

CPU = torch.device("cpu")
F420 = ((2, 2), (1, 1), (1, 1))
PALLAS = EntropyBackend.PALLAS
FANCY = DecodeConfig(upsample="fancy", quirks=Quirks.CORRECT)


def _jax_cfg(cfg: DecodeConfig):
    return jt.DecodeConfig(
        quirks=jt.Quirks[cfg.quirks.name],
        idct_precision=jt.IdctPrecision[cfg.idct_precision.name],
        entropy_backend=jt.EntropyBackend.NATIVE,
        upsample=cfg.upsample, scale=cfg.scale)


def _assert_rgb(got, want, cfg):
    assert got.shape == want.shape and got.dtype == np.uint8
    if cfg.idct_precision == IdctPrecision.EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


#: Five same-geometry 64x48 4:2:0 requests (a marker per MCU row), and two
#: of other geometries for decode_many.
BATCH = [make_jpeg(64, 48, F420, 4, 200 + s) for s in range(5)]
OTHERS = [make_jpeg(40, 40, ((1, 1),) * 3, 5, 210), make_jpeg(30, 20, ((1, 1),), 0, 211)]
#: A tall 4:2:0 frame, 13 MCU rows, a marker per MCU row.
TALL = make_jpeg(48, 200, F420, 3, 4)


def test_make_mesh_without_a_group_is_one_by_one():
    m = tmesh.make_mesh()
    assert m.shape == (1, 1)
    assert m.mesh_dim_names == (tmesh.DATA_AXIS, tmesh.STRIPE_AXIS) == ("data", "stripe")
    assert tuple(m.get_coordinate()) == (0, 0)
    for sharding in (tmesh.batch_sharding(m), tmesh.stripe_sharding(m), tmesh.replicated(m)):
        assert (sharding.size, sharding.index) == (1, 0)
        assert sharding.local([7, 8, 9]) == [7, 8, 9]
    x = torch.arange(6)
    assert tmesh.stripe_sharding(m).gather(x) is x
    top, bottom = tmesh.stripe_sharding(m).halo_exchange(x[:2], x[4:])
    assert top is not None and torch.equal(top, x[:2]) and torch.equal(bottom, x[4:])


@pytest.mark.parametrize("n_data, n_stripe, devices, match", [
    (2, 1, None, "mesh 2x1 needs 2 devices, have 1"),
    (1, 2, None, "mesh 1x2 needs 2 devices, have 1"),
    (1, 1, [1], "not all in a process group of 1"),
])
def test_make_mesh_without_a_group_raises_past_one(n_data, n_stripe, devices, match):
    """The JAX ValueError past this process's one device, or a rank outside
    the (absent) group."""
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh(n_data=n_data, n_stripe=n_stripe, devices=devices)


def test_process_info_without_a_group():
    """The JAX version's four keys; one process, one device."""
    assert multihost.process_info() == {"process_index": 0, "process_count": 1,
                                        "local_devices": 1, "global_devices": 1}
    assert not multihost.is_distributed()


@functools.lru_cache(maxsize=None)
def _jax_mesh(n_data, n_stripe):
    return jmesh.make_mesh(n_data=n_data, n_stripe=n_stripe,
                           devices=jax.devices()[:n_data * n_stripe])


@pytest.mark.parametrize("backend", [EntropyBackend.NATIVE, PALLAS])
def test_one_by_one_mesh_batches_are_bitwise_no_mesh(backend):
    """decode_batch, decode_stream and decode_many over a 1 x 1 mesh:
    bitwise without a mesh, and the JAX decode_batch over its 1 x 1 mesh."""
    cfg = DecodeConfig(entropy_backend=backend)
    meshed = jtt.BatchDecoder(cfg, CPU, tmesh.make_mesh())
    plain = jtt.BatchDecoder(cfg, CPU)
    got = meshed.decode_batch(BATCH)
    np.testing.assert_array_equal(got, plain.decode_batch(BATCH))
    np.testing.assert_array_equal(got, jbatch.decode_batch(BATCH, _jax_cfg(cfg), _jax_mesh(1, 1)))
    stream = list(meshed.decode_stream(BATCH))
    assert [len(s) for s in stream] == [2, 2, 1]  # two images a data rank
    np.testing.assert_array_equal(np.concatenate(stream), got)
    mixed = [BATCH[0], *OTHERS, BATCH[1]]
    for a, b in zip(meshed.decode_many(mixed), plain.decode_many(mixed)):
        np.testing.assert_array_equal(a, b)
    assert jtt.decode_batch(BATCH, cfg, CPU, tmesh.make_mesh()).shape == got.shape


STRIPED = {
    "nn": DecodeConfig(),
    "fancy": FANCY,
    "fancy_pallas": FANCY.replace(entropy_backend=PALLAS),
    "fancy_float32": FANCY.replace(idct_precision=IdctPrecision.FLOAT32),
}


@pytest.mark.parametrize("name", sorted(STRIPED))
def test_one_by_one_mesh_striped_is_bitwise_no_mesh(name):
    cfg = STRIPED[name]
    got = tstripes.decode_striped(TALL, cfg, device=CPU, mesh=tmesh.make_mesh())
    np.testing.assert_array_equal(got, tstripes.decode_striped(TALL, cfg, n_stripes=1,
                                                               device=CPU))
    _assert_rgb(got, jstripes.decode_striped(TALL, _jax_cfg(cfg), _jax_mesh(1, 1)), cfg)
    with pytest.raises(ValueError, match="stripe axis"):
        tstripes.decode_striped(TALL, cfg, n_stripes=2, device=CPU, mesh=tmesh.make_mesh())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_halo_exchange_rows_matches_jax_ppermute(n):
    """The port's halo function over a list of stripe planes, bitwise the JAX
    _halo_exchange_rows under shard_map over n devices."""
    rows, w = 3, 5
    x = np.random.default_rng(n).integers(0, 256, (n * rows, w)).astype(np.float32)
    f = jax.shard_map(lambda s: jstripes._halo_exchange_rows(s, jmesh.STRIPE_AXIS),
                      mesh=_jax_mesh(1, n), in_specs=P(jmesh.STRIPE_AXIS),
                      out_specs=P(jmesh.STRIPE_AXIS))
    want = np.asarray(jax.jit(f)(jnp.asarray(x)))
    got = torch.cat(tstripes._halo_exchange_rows(list(torch.from_numpy(x).split(rows))))
    np.testing.assert_array_equal(got.numpy(), want)


def _resident_exchanges(stage, stripe_planes):
    """Each stripe's exchange(first, last): its neighbours' edge rows, its
    own at the two ends (a mesh's stripe axis within one process)."""
    edges = [stage.edge_rows(stage._pixel_plain(p)) for p in stripe_planes]
    n = len(edges)
    return [lambda first, last, k=k: (edges[k - 1][2] if k else first,
                                      edges[k + 1][1] if k < n - 1 else last)
            for k in range(n)]


#: name -> (bytes, config, stripes): geometries whose stripes read halo rows
#: (4:2:0, 4:4:0 vertical only, four components), read none (4:2:2:
#: horizontal only) or take the rule ((2, 4) ratio), at heights that pad.
K6H_CASES = {
    "420_h123_3": (make_jpeg(48, 123, F420, 3, 21), FANCY, 3),
    "420_h208_8": (make_jpeg(48, 208, F420, 3, 22), FANCY, 8),
    "420_h200_2_float32": (make_jpeg(48, 200, F420, 3, 23),
                           FANCY.replace(idct_precision=IdctPrecision.FLOAT32), 2),
    "440_h64_4": (make_jpeg(32, 64, ((1, 2), (1, 1), (1, 1)), 4, 24), FANCY, 4),
    "422_h40_2": (make_jpeg(32, 40, ((2, 1), (1, 1), (1, 1)), 2, 25), FANCY, 2),
    "ratio_2x4_4": (make_jpeg(32, 100, ((2, 4), (1, 1), (1, 1)), 2, 26), FANCY, 4),
    "ycck_3": (make_jpeg(40, 48, F420 + ((2, 2),), 3, 27, adobe_transform=2), FANCY, 3),
    "420_reference_nn_4": (make_jpeg(48, 80, F420, 3, 28), DecodeConfig(), 4),
}


@pytest.mark.parametrize("name", sorted(K6H_CASES))
def test_stripe_alone_kernel_route_matches_plain_route(name):
    """Stripe by stripe with the neighbours' edge rows: the kernel route
    (K6h's wrapper with halo rows, or K6n) bitwise the plain route, and
    their concatenation bitwise the one-process StripeStage."""
    data, cfg, n = K6H_CASES[name]
    stage, planes = tstripes._striped_planes(parse(data, cfg), cfg, n, CPU)
    parts = stage._stripes(planes)
    exchanges = _resident_exchanges(stage, parts)
    plain = [stage.stripe(k, p, exchanges[k]) for k, p in enumerate(parts)]
    route = [stage._stripe_launches(k, p, exchanges[k]) for k, p in enumerate(parts)]
    for a, b in zip(route, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(torch.cat(plain).numpy(), stage(*planes).numpy())


@pytest.mark.parametrize("h, n", [(80, 4), (123, 3), (200, 8)])
@pytest.mark.parametrize("backend", [EntropyBackend.NATIVE, PALLAS])
def test_entropy_decode_stripe_is_the_one_process_stripe(h, n, backend):
    """A rank's own stripe of block rows (its restart segments alone where
    the plan allows; a stripe wholly in padding rows at h 80 in 4) bitwise
    the one-process padded planes' stripe."""
    data = make_jpeg(48, h, F420, 3, 30 + h)
    cfg = DecodeConfig(entropy_backend=backend)
    structure = parse(data, cfg)
    stage, planes = tstripes._striped_planes(structure, cfg, n, CPU)
    for k, want in enumerate(stage._stripes(planes)):
        got, qts = tstripes.entropy_decode_stripe(structure, cfg, n, k, CPU)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_planes_to_rgb_refuses_halos_out_of_place():
    """Halo rows are one fancy stripe's, given exactly where takes_halo
    holds, each a uint8 row of its plane."""
    planes = [torch.zeros((16, 16), dtype=torch.uint8), torch.zeros((8, 8), dtype=torch.uint8),
              torch.zeros((8, 8), dtype=torch.uint8)]
    row = torch.zeros((1, 8), dtype=torch.uint8)
    good = [None, (row, row), (row, row)]
    stripes = tcolor.Stripes(0, 16)
    out = tcolor.planes_to_rgb(planes, 16, 16, F420, Quirks.CORRECT, "fancy", stripes=stripes,
                               halos=good)
    assert out.shape == (16, 16, 3)
    for bad, kw in ((good, dict(upsample="nn")), (good, dict(stripes=None)),
                    ([(row, row)] * 3, {}), ([None, None, (row, row)], {}),
                    ([None, (row, row[:, :4]), (row, row)], {}),
                    ([None, (row, row.to(torch.int16)), (row, row)], {})):
        args = dict(upsample="fancy", stripes=stripes, halos=bad)
        args.update(kw)
        with pytest.raises(ValueError, match="halo"):
            tcolor.planes_to_rgb(planes, 16, 16, F420, Quirks.CORRECT, **args)


def _jax_dryrun(n_devices):
    """The JAX dry run's step (__graft_entry__.dryrun_multichip) on the
    8-device CPU mesh, returning what it asserts on: (rgb, coefficients)."""
    import __graft_entry__ as graft

    n_stripe = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_stripe
    mesh = _jax_mesh(n_data, n_stripe)
    key, frame, coeffs, _cfg = graft._tiny_coeffs(h=16 * n_stripe, w=32)
    key = key[:4] + ("fancy",) + key[5:]
    shard_fn = jstripes.make_shard_fn(key, n_stripe)
    batch = n_data * 2
    dp_sp = P(jmesh.DATA_AXIS, jmesh.STRIPE_AXIS)
    mapped = jax.shard_map(lambda *cb: jax.vmap(shard_fn)(*cb), mesh=mesh,
                           in_specs=(dp_sp,) * frame.ncs, out_specs=dp_sp)
    rgb = np.asarray(jax.jit(mapped)(*[jnp.asarray(np.stack([c] * batch)) for c in coeffs]))
    return rgb


def jax_fdct_of(rgb):
    """The JAX re-encode leg over given pixels: fdct_quantize(plane_to_blocks
    (rgb[..., 0])) at quality 85, image by image."""
    qt_l, _ = jencoder.quality_qtables(85)
    b, hh, ww = rgb.shape[:3]
    return np.stack([np.asarray(jfdct.fdct_quantize(
        jfdct.plane_to_blocks(jnp.asarray(img[..., 0]), hh // 8, ww // 8), qt_l)) for img in rgb])


def test_dryrun_multichip_on_one_rank():
    from jpeg_decoder_tpu_torch.entry import _tiny_coeffs, dryrun_multichip

    rgb, coeffs = dryrun_multichip(1, "cpu")
    assert rgb.shape == (2, 16, 32, 3) and coeffs.shape == (2, 8, 64)
    assert coeffs.dtype == np.int32
    want = _jax_dryrun(1)
    assert rgb.shape == want.shape
    assert np.abs(rgb.astype(np.int32) - want.astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(coeffs, jax_fdct_of(rgb))
    frame, planes, qts, cfg = _tiny_coeffs(h=16, w=32)
    whole = tstripes.StripeStage(tstripes._stage_for(frame, qts, cfg.replace(upsample="fancy")),
                                 1, CPU)(*[torch.from_numpy(p) for p in planes.planes])
    np.testing.assert_array_equal(rgb[1], whole.numpy())
