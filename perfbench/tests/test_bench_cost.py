"""The shape-based operation and byte counts against hand-worked values."""

from perfbench.bench import peaks
from perfbench.cost import glow, unet

CFG = {"image": {"size": 8, "channels": 3}, "flow": {"L": 2, "K": 1, "coupling_width": 4}}


def test_glow_level_shapes():
    assert glow.level_shapes(CFG) == [(4, 4, 12), (2, 2, 24)]
    big = {"image": {"size": 32, "channels": 3}, "flow": {"L": 3, "K": 16, "coupling_width": 512}}
    assert glow.level_shapes(big) == [(16, 16, 12), (8, 8, 24), (4, 4, 48)]


def test_glow_flops_by_hand():
    # level 1: 16 px, C 12, W 4: mix 2*16*144, conv1 2*16*9*6*4, conv2 2*16*16, zconv 2*16*4*9*12
    l1 = 2 * 16 * (144 + 216 + 16 + 432)
    l2 = 2 * 4 * (576 + 9 * 12 * 4 + 16 + 9 * 4 * 24)
    split = 2 * 16 * 9 * 6 * 12
    assert glow.flow_flops_per_image(CFG, splits=False) == l1 + l2
    assert glow.flow_flops_per_image(CFG, splits=True) == l1 + l2 + split


def test_mix_tail_bytes_by_hand():
    b = 2
    n1, n2 = b * 16, b * 4
    fwd = (4 * (2 * n1 * 12 + 144 + 12) + 4 * (3 * n1 * 12 + 24 + 4)
           + 4 * (2 * n2 * 24 + 576 + 24) + 4 * (3 * n2 * 24 + 48 + 4))
    ops = 2 * n1 * 144 + 2 * n2 * 576
    assert glow.mix_tail_work(CFG, b, ("forward",)) == (fwd, ops)
    inv = (4 * (2 * n1 * 12 + 156) + 4 * (3 * n1 * 12 + 24)
           + 4 * (2 * n2 * 24 + 600) + 4 * (3 * n2 * 24 + 48))
    assert glow.mix_tail_work(CFG, b, ("inverse",))[0] == inv
    bwd = (4 * (2 * n1 * 12 + 144) + 4 * (9 * n1 * 12 // 2 + 48 + b)
           + 4 * (2 * n2 * 24 + 576) + 4 * (9 * n2 * 24 // 2 + 96 + b))
    assert glow.mix_tail_work(CFG, b, ("backward",))[0] == bwd


def test_linear_attention_by_hand():
    # n 4 tokens, c 8: qkv 2*4*8*384, k^T v and q ctx 2 * 2*4*128*32, out 2*4*128*8
    assert unet.linear_attention_ops(4, 8) == 2 * 4 * 8 * 384 + 2 * 2 * 4 * 4096 + 2 * 4 * 1024
    assert unet.linear_attention_bytes(3, 4, 8) == 4 * (2 * 3 * 4 * 8 + 4 * 128 * 8 + 16)


def test_unet_walk_by_hand():
    # dim 2, mults [1], 4x4x1 input: init 7x7 1->2, level (2, 2): two resnets, attention,
    # the last level's 3x3 2->2; mid resnets and attention at 4x4; up: resnets 4->2, attn,
    # 3x3 2->2; final resnet 4->2 (with its 1x1), 1x1 2->1
    px = 16
    conv = lambda cin, cout, k: 2 * px * cin * cout * k * k  # noqa: E731
    res = lambda a, b: conv(a, b, 3) + conv(b, b, 3) + (conv(a, b, 1) if a != b else 0)  # noqa
    want = (conv(1, 2, 7) + 2 * res(2, 2) + unet.linear_attention_ops(px, 2) + conv(2, 2, 3)
            + 2 * res(2, 2) + unet.full_attention_ops(px, 2)
            + 2 * res(4, 2) + unet.linear_attention_ops(px, 2) + conv(2, 2, 3)
            + res(4, 2) + conv(2, 1, 1))
    ops, attn = unet.walk(4, 1, 2, [1])
    assert ops == want and attn == [(16, 2), (16, 2)]


def test_least_seconds_names_its_bound():
    assert peaks.least_seconds(3.35e12, 0) == (1.0, "bytes")
    t, by = peaks.least_seconds(0, 165e12)
    assert by == "operations" and abs(t - 1.0) < 1e-12
