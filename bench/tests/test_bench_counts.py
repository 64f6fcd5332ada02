"""The frozen FLOP and byte counts against hand counts at the yi-6b and
olmoe-1b-7b geometries."""
import json

import tinycell
from harness import counts
from harness.counts import Geometry


def geom(name):
    conf = json.loads((tinycell.BENCH / "configs" / f"{name}.json")
                      .read_text())
    return Geometry.of(conf)


def test_yi6b_active_params_by_hand():
    g = geom("yi-6b")
    # q 4096x4096, k and v 4096x512 each, o 4096x4096, SwiGLU 3x4096x11008
    per_layer = 4096 * 4096 * 2 + 4096 * 512 * 2 + 3 * 4096 * 11008
    assert counts.active_params(g) == 32 * per_layer == 5_536_481_280
    # embedding and head beside them: 2 x 64000 x 4096 -> 6.16e9 in all
    assert counts.active_params(g) + 2 * 64000 * 4096 == 6_060_769_280


def test_olmoe_active_params_by_hand():
    g = geom("olmoe-1b-7b")
    attn = 4 * 2048 * 2048
    moe = 2048 * 64 + 8 * 3 * 2048 * 1024
    assert counts.active_params(g) == 16 * (attn + moe) == 1_075_838_976


def test_span_flops_by_hand():
    g = geom("yi-6b")
    n2 = 2 * counts.active_params(g)
    per_key = 4 * 128 * 32 * 32
    # positions 3, 4 attend to 4 and 5 keys
    assert counts.span_flops(g, 3, 5) == 2 * n2 + per_key * (4 + 5)
    assert counts.span_flops(g, 7, 7) == 0
    assert counts.head_flops(g) == 2 * 4096 * 64000


def test_decode_bytes_by_hand():
    g = geom("yi-6b")
    # two lanes of 100 and 300 visible tokens: K and V, 4 KV heads x 128
    # at 2 bytes, 32 layers; q and out 32 heads x 128 at 2 bytes
    kv = (100 + 300) * 32 * 4 * 128 * 2 * 2
    q_out = 2 * 32 * 32 * 128 * 2 * 2
    assert counts.decode_attn_bytes(g, [100, 300]) == kv + q_out
    o = geom("olmoe-1b-7b")
    assert counts.decode_attn_bytes(o, [10]) == \
        10 * 16 * 16 * 128 * 4 + 16 * 16 * 128 * 4


def test_peaks_are_the_data_sheets():
    assert counts.BF16_PEAK_FLOPS == 989e12
    assert counts.HBM_BYTES_PER_S == 3.35e12
