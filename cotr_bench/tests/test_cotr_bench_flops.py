"""The yardstick's arithmetic against counts worked out by hand."""

import pytest

from cotr_bench import flops

SIZES = dict(layer="layer3", hidden_dim=256, nheads=8, enc_layers=6,
             dec_layers=6, backbone_channels=1024, ffn_dim=1024,
             dtype="bfloat16")


def test_encoder_layer_over_512_tokens():
    # projections 8 L d^2, products 4 L S d, FFN 4 L d F
    want = 8 * 512 * 256 ** 2 + 4 * 512 * 512 * 256 + 4 * 512 * 256 * 1024
    assert flops.attention_layer_flops(1, 512, 512, 256, 1024, True) == want
    assert want == 1_073_741_824


def test_decoder_layer_projects_the_memory_once_a_call():
    b, lq, s, d, f = 8, 64, 512, 256, 1024
    want = (4 * b * lq * d * d + 4 * b * s * d * d + 4 * b * lq * s * d
            + 4 * b * lq * d * f)
    assert flops.attention_layer_flops(b, lq, s, d, f, False) == want


def test_resnet50_to_layer3_on_a_256_square():
    # stem 7x7/2 on 128^2, then by hand: layer1 at 64^2, layer2 to 32^2,
    # layer3 to 16^2 (bottleneck v1.5, projection on each first block)
    stem = 2 * 3 * 64 * 49 * 128 * 128
    l1 = 2 * 64 * 64 * 4096 + 2 * 64 * 64 * 9 * 4096 + 2 * 64 * 256 * 4096 \
        + 2 * 64 * 256 * 4096
    l1 += 2 * (2 * 256 * 64 * 4096 + 2 * 64 * 64 * 9 * 4096
               + 2 * 64 * 256 * 4096)
    l2 = 2 * 256 * 128 * 4096 + 2 * 128 * 128 * 9 * 1024 \
        + 2 * 128 * 512 * 1024 + 2 * 256 * 512 * 1024
    l2 += 3 * (2 * 512 * 128 * 1024 + 2 * 128 * 128 * 9 * 1024
               + 2 * 128 * 512 * 1024)
    l3 = 2 * 512 * 256 * 1024 + 2 * 256 * 256 * 9 * 256 \
        + 2 * 256 * 1024 * 256 + 2 * 512 * 1024 * 256
    l3 += 5 * (2 * 1024 * 256 * 256 + 2 * 256 * 256 * 9 * 256
               + 2 * 256 * 1024 * 256)
    assert flops.backbone_flops(SIZES) == stem + l1 + l2 + l3
    assert 7.5e9 < flops.backbone_flops(SIZES) < 9e9


def test_serve_flops_counts_canvases_and_queries_from_shapes():
    counts = {(8, 512, 512, "bfloat16"): 6, (8, 64, 512, "bfloat16"): 6}
    canvas = flops.canvas_flops(SIZES)
    dec = flops.attention_layer_flops(8, 64, 512, 256, 1024, False)
    head = 2 * (2 * 256 * 256 + 2 * 256)
    want = 8 * canvas + 6 * dec + 8 * 64 * head
    assert flops.serve_flops(counts, SIZES) == pytest.approx(want)


def test_attention_bound_of_the_dense_decode_is_its_operations():
    # (8, 8192) over 512 keys in bf16: 71,303,168 bytes (21.3 us) against
    # 34,359,738,368 operations (34.7 us at 989 TFLOP/s)
    got = flops.attention_bound_s(8, 8192, 512, 8, 32, "bfloat16")
    assert got == pytest.approx(34_359_738_368 / 989e12)


def test_attention_bound_of_a_row_decode_is_its_bytes():
    got = flops.attention_bound_s(256, 1, 512, 8, 32, "float32")
    nbytes = 4 * (2 * 256 * 1 * 8 * 32 + 2 * 256 * 512 * 8 * 32)
    assert got == pytest.approx(nbytes / 3.35e12)


def test_train_step_counts_two_forwards_and_one_backward():
    b, q = 24, 200
    bb = 2 * flops.backbone_flops(SIZES) * b
    rest = (flops.canvas_flops(SIZES) - 2 * flops.backbone_flops(SIZES)) * b
    rest += 6 * flops.attention_layer_flops(b, q, 512, 256, 1024, False)
    rest += b * q * 2 * (2 * 256 * 256 + 2 * 256)
    assert flops.train_step_flops(SIZES, b, q) == pytest.approx(
        2 * bb + 6 * rest)
