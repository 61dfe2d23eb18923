"""Port parity for the cost model (`deepreduce_tpu_torch/costmodel.py`, a
copy of the JAX package's pricing and selector half): every selector's
pick, `select_hier_plan`'s whole table, the wire bytes and the modeled
times equal the JAX package's with `==` over a grid of d, W, ratio, the
sketch / headroom knobs and three profiles (none, the static one, and a
fitted v2 record with route rows); a profile the JAX package saved loads in
the port, and `validate_profile` rejects the same malformed records. Pure
float arithmetic on the host: no compile."""

import itertools

import pytest

from deepreduce_tpu import costmodel as jcm
from deepreduce_tpu_torch import costmodel as cm

DS = (5_003, 200_000, 4_050_748)
WS = (1, 2, 4, 8, 32)
RATIOS = (0.01, 0.1)
KNOBS = (
    {},
    dict(rows=3, cols=0, headroom=1.5, out_headroom=2.0),
    dict(rows=7, cols=4096, block=512, bins=1024, cap_headroom=3.0),
)
ROUTES = {"fused": (0.004, 0.0015, 12), "sparse": (0.003, 0.001, 9), "quantized": (0.0025, 0.0008, 9),
          "sketch": (0.006, 0.002, 6), "qar": (0.001, 0.0005, 9)}


def _fitted(pkg):
    """A v2 profile with fitted bandwidths, encode/decode and route rows."""
    return pkg.MachineProfile(
        bw_dcn=3.1e7, bw_ici=4.7e9, t_enc_s=0.0021, t_dec_s=0.0009, compute_time_s=0.013,
        fitted=("bw_dcn", "t_enc", "t_dec", "compute_time"), fixed=("bw_ici",),
        routes={k: {"t_enc_s": e, "t_dec_s": d, "samples": n} for k, (e, d, n) in ROUTES.items()},
        source={"run": "synthetic"},
    )


PROFILES = {"none": (None, None), "static": (jcm.static_profile(), cm.static_profile()),
            "fitted": (_fitted(jcm), _fitted(cm))}


@pytest.mark.parametrize("profile", list(PROFILES))
def test_select_rs_mode_and_rs_wire_bytes_equal_jax(profile):
    jp, tp = PROFILES[profile]
    picks = set()
    for d, W, ratio, knobs in itertools.product(DS, WS, RATIOS, KNOBS):
        for modes in (None, ("sparse", "quantized", "oktopk")):
            want = jcm.select_rs_mode(d, W, ratio, modes=modes, profile=jp, **knobs)
            assert cm.select_rs_mode(d, W, ratio, modes=modes, profile=tp, **knobs) == want, (d, W, ratio, knobs)
            picks.add(want)
        for mode in ("sparse", "adaptive", "quantized", "sketch", "oktopk"):
            for masked in (False, True):
                assert cm.rs_wire_bytes(mode, d, W, ratio, masked=masked, **knobs) == jcm.rs_wire_bytes(
                    mode, d, W, ratio, masked=masked, **knobs), (mode, d, W, ratio, knobs)
            assert cm.rs_step_time(mode, d, W, ratio, profile=tp, compute_time=0.01, **knobs) == jcm.rs_step_time(
                mode, d, W, ratio, profile=jp, compute_time=0.01, **knobs)
        rows, cols = knobs.get("rows", 5), knobs.get("cols", 0)
        assert cm.sketch_cols(d, ratio, rows, cols) == jcm.sketch_cols(d, ratio, rows, cols)
    assert len(picks) >= 2  # the grid reaches more than one route


@pytest.mark.parametrize("profile", list(PROFILES))
def test_select_hier_plan_and_leg_times_equal_jax(profile):
    jp, tp = PROFILES[profile]
    plans = set()
    for d, ratio, (S, P), knobs in itertools.product(DS, RATIOS, [(1, 2), (2, 2), (2, 4), (4, 8), (8, 1)],
                                                     KNOBS[:2]):
        for dcn_legs, stream in ((None, False), (("fused", "sparse", "adaptive", "quantized", "sketch"), False),
                                 (("bucketed", "quantized"), True)):
            kw = dict(ici_block=512, dcn_legs=dcn_legs, stream=stream, compute_time=0.02, **knobs)
            want = jcm.select_hier_plan(d, S, P, ratio, profile=jp, **kw)
            got = cm.select_hier_plan(d, S, P, ratio, profile=tp, **kw)
            assert got == want, (d, S, P, ratio, knobs, dcn_legs)
            plans.add((want["ici"], want["dcn"]))
        for ici in cm.HIER_ICI_LEGS:
            assert cm.hier_ici_time(ici, d, P, profile=tp) == jcm.hier_ici_time(ici, d, P, profile=jp)
        for dcn in cm.HIER_DCN_LEGS:
            assert cm.hier_dcn_time(dcn, d, S, ratio, profile=tp, **knobs) == jcm.hier_dcn_time(
                dcn, d, S, ratio, profile=jp, **knobs)
            assert cm.hier_step_time("qar", dcn, d, S, P, ratio, profile=tp, **knobs) == jcm.hier_step_time(
                "qar", dcn, d, S, P, ratio, profile=jp, **knobs)
        for dcn in ("fused", "bucketed"):
            assert cm.stream_hier_step_time(dcn, d, S, P, ratio, profile=tp, compute_time=0.05) == (
                jcm.stream_hier_step_time(dcn, d, S, P, ratio, profile=jp, compute_time=0.05))
        assert cm.qar_wire_bytes_per_worker(d, P) == jcm.qar_wire_bytes_per_worker(d, P)
    assert len(plans) >= 2
    assert cm.HIER_ICI_LEGS == jcm.HIER_ICI_LEGS and cm.HIER_DCN_LEGS == jcm.HIER_DCN_LEGS


def test_flat_and_fed_estimators_equal_jax():
    m = {"payload_bytes": 1_189_616.0, "t_encode_s": 0.01, "t_decode_s": 0.004}
    for profile in PROFILES:
        jp, tp = PROFILES[profile]
        for W in WS:
            assert cm.exchange_time(m, profile=tp) == jcm.exchange_time(m, profile=jp)
            assert cm.fused_step_time(m, W, profile=tp) == jcm.fused_step_time(m, W, profile=jp)
            assert cm.overlapped_step_time(m, W, profile=tp) == jcm.overlapped_step_time(m, W, profile=jp)
            assert cm.overlap_fraction(m, W, compute_time=0.2, profile=tp) == jcm.overlap_fraction(
                m, W, compute_time=0.2, profile=jp)
    assert cm.dense_measurement(4_050_748) == jcm.dense_measurement(4_050_748)
    assert cm.fed_round_time(1e6, 10, t_client_s=0.5) == jcm.fed_round_time(1e6, 10, t_client_s=0.5)
    assert cm.fed_clients_per_sec(1e6, 10) == jcm.fed_clients_per_sec(1e6, 10)
    assert cm.expected_staleness((0.5, 0.3, 0.2)) == jcm.expected_staleness((0.5, 0.3, 0.2))
    assert cm.peak_hbm_bytes("fused", 4_050_748, 4) == jcm.peak_hbm_bytes("fused", 4_050_748, 4)


def test_wordlstm_picks_pinned():
    """The picks at the WordLSTM's d and ratio 0.1 under the static profile,
    which phase 17 of chip_smoke.py relies on."""
    d, p = 4_050_748, cm.static_profile()
    assert [cm.select_rs_mode(d, W, 0.1, profile=p) for W in (1, 2, 4, 8)] == ["sparse", "oktopk", "oktopk",
                                                                                "oktopk"]
    plan = cm.select_hier_plan(d, 2, 2, 0.1, ici_block=512, profile=p,
                               dcn_legs=("fused", "sparse", "adaptive", "quantized", "sketch"))
    assert (plan["ici"], plan["dcn"]) == ("qar", "fused")
    assert cm.rs_payload_bytes("sketch", d, 1, 0.1) == 6_481_192
    assert cm.rs_payload_bytes("sketch", d, 4, 0.1) == 4_050_752
    assert cm.sketch_cols(d, 0.1, 5) == 162_030


def test_jax_saved_profile_loads_and_prices_alike(tmp_path):
    path = tmp_path / "profile.json"
    _fitted(jcm).save(path)
    tp = cm.load_profile(path)
    jp = jcm.load_profile(path)
    assert tp.to_record() == jp.to_record() and tp.content_hash() == jp.content_hash()
    assert cm.PROFILE_SCHEMA == jcm.PROFILE_SCHEMA
    d = 200_000
    assert cm.select_hier_plan(d, 2, 4, 0.1, profile=tp) == jcm.select_hier_plan(d, 2, 4, 0.1, profile=jp)
    # a v1 record (no route table) loads in both
    rec = dict(jp.to_record(), schema=jcm.PROFILE_SCHEMA_V1)
    del rec["routes"]
    assert cm.MachineProfile.from_record(rec).routes == {} == jcm.MachineProfile.from_record(rec).routes


def _bad_records():
    good = cm.static_profile().to_record()
    routes = {"fused": {"t_enc_s": 0.1, "t_dec_s": 0.1, "samples": 3}}
    yield []
    yield dict(good, schema="deepreduce_tpu/machine-profile/v9")
    yield dict(good, schema=cm.PROFILE_SCHEMA_V1, routes={})
    yield dict(good, bw_dcn_bytes_per_s=0.0)
    yield dict(good, t_enc_s=-1.0)
    yield dict(good, t_dec_s=float("nan"))
    yield dict(good, compute_time_s=True)
    yield dict(good, fitted=["bw_dcn"], fixed=["bw_dcn"])
    yield dict(good, fitted="bw_dcn")
    yield dict(good, source=[])
    yield dict(good, routes=[])
    yield dict(good, routes={"": routes["fused"]})
    yield dict(good, routes={"fused": dict(routes["fused"], extra=1)})
    yield dict(good, routes={"fused": dict(routes["fused"], t_enc_s=-0.1)})
    yield dict(good, routes={"fused": dict(routes["fused"], samples=0)})


@pytest.mark.parametrize("rec", list(_bad_records()), ids=lambda r: str(r)[:40])
def test_validate_profile_rejects_what_jax_rejects(rec):
    with pytest.raises(ValueError) as want:
        jcm.validate_profile(rec)
    with pytest.raises(ValueError) as got:
        cm.validate_profile(rec)
    assert str(got.value) == str(want.value)
