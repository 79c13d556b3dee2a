"""The yardstick's and the reductions' arithmetic on hand-made samples."""
import math

import numpy as np
import pytest
import torch

from portbench.lib import trace as tr
from portbench.lib import yardstick as ys
from portbench.lib.runner import quantile
from portbench.lib.traffic import Requests, clip_lengths, lengths_drawn


def test_p95_is_over_all_samples_not_over_medians_of_chunks():
    # two requests: one of fast chunks, one with a slow tail
    fast, slow = [0.1] * 90, [0.1] * 5 + [0.5] * 5
    gaps = fast + slow
    assert quantile(gaps, 0.95) == pytest.approx(np.percentile(gaps, 95))
    # sorted, position 0.95 * 99 = 94.05 lies between the last 0.1 and the first 0.5
    assert quantile(gaps, 0.95) == pytest.approx(0.1 + 0.05 * 0.4)
    medians = [np.median(fast), np.median(slow)]
    assert quantile(gaps, 0.95) != pytest.approx(quantile(medians, 0.95))
    assert quantile([3.0], 0.95) == 3.0
    with pytest.raises(ValueError):
        quantile([], 0.95)


def test_idle_share_is_the_gaps_in_the_union_of_kernel_intervals():
    kernels = [("a", 0, 100), ("b", 50, 150), ("c", 300, 400), ("Memcpy DtoH", 390, 450)]
    assert tr.union_intervals(kernels) == [[0, 150], [300, 450]]
    assert tr.busy_seconds(kernels) == pytest.approx(300e-9)
    run = tr.Run(cell="c", config={}, traffic={}, kernels=kernels, window_s=600e-9)
    assert tr.idle_share(run) == pytest.approx(50.0)
    assert tr.idle_share(tr.Run(cell="c", config={}, traffic={})) is None
    spans = [("request", 0, 1000), ("fetch_wait", 140, 350)]
    assert tr.idle_gaps(kernels, spans) == [["fetch_wait", pytest.approx(150e-9)]]
    assert tr.idle_gaps(kernels, []) == [["host", pytest.approx(150e-9)]]


def test_kernel_kinds_and_device_seconds():
    names = {"raster_walk_kernel": "kernels", "grid_sample_rgb4_kernel": "kernels",
             "sm80_xmma_fprop_implicit_gemm_f32": "convolutions",
             "void DSE::vector_fft<0, 1, 128>": "convolutions",
             "void cudnn::detail::dgrad_engine<float>": "convolutions",
             "Memcpy DtoH (Device -> Pinned)": "copies",
             "void at::native::elementwise_kernel<128, 2>": "other",
             "void cub::DeviceRadixSortOnesweepKernel": "binning_sort_scan"}
    for name, kind in names.items():
        assert tr.kernel_kind(name) == kind, name
    assert tr.K1_KERNELS.search("raster_epilogue_kernel<true>") and not tr.K1_KERNELS.search("grid_sample_rgb4_kernel")
    assert tr.K2_KERNELS.search("repack_rgb4_kernel")
    kernels = [("raster_walk_kernel", 0, 2000), ("x", 0, 1000)]
    assert tr.device_seconds(kernels, lambda n: tr.K1_KERNELS.search(n) is not None) == pytest.approx(2e-6)


def test_grid_sample_bound_counts_each_byte_once():
    # 2 frames of 4 x 4, 3 channels, one shared 8 x 8 image: bytes bound the call
    b = ys.grid_sample_bound_s(2, 8, 8, 3, 4, 4)
    moved = 4 * (8 * 8 * 3 + 2 * 4 * 4 * 2 + 2 * 4 * 4 * 3)
    ops = 2 * 4 * 4 * 3 * 8 + 2 * 4 * 4 * 2 * 6
    assert b == pytest.approx(max(moved / ys.PEAK_BYTES_PER_S, ops / ys.PEAK_F32_FLOPS))


def test_raster_flops_count_the_pairs_a_face_box_covers():
    # at S = 16 the pixel centres are -0.9375 + 0.125 i and the guard is 2 / S:
    # the box [-0.3, 0.3] widened to [-0.425, 0.425] holds i = 5 .. 10 on each axis
    fv = torch.tensor([[[-0.3, -0.3, 2.0], [0.3, -0.3, 2.0], [-0.3, 0.3, 2.0]]])
    assert ys.raster_flops(fv, 16, 0) == 6 * 6 * 30
    assert ys.raster_flops(fv, 16, 10) == 6 * 6 * 30 + 50
    # a face wholly off screen needs nothing
    assert ys.raster_flops(fv + torch.tensor([5.0, 0.0, 0.0]), 16, 0) == 0
    b = ys.raster_flows_bound_s(fv[None], 16, 3)
    n_out = 16 * 16 * 3 * 2
    moved = 4 * (9 + 3 * 1 * 6 + 16 * 16 + n_out)
    ops = 6 * 6 * 30 + n_out * 5
    assert b == pytest.approx(max(moved / ys.PEAK_BYTES_PER_S, ops / ys.PEAK_F32_FLOPS))


def test_count_flops_matches_hand_counts():
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.ConvTranspose2d(8, 4, 4, 2, 1))
    flops = ys.count_flops(net, lambda: net(torch.zeros(1, 3, 16, 16)))
    conv = 2 * (8 * 16 * 16) * (3 * 3 * 3)
    deconv = 2 * (8 * 16 * 16) * (4 * 4 * 4)
    assert flops == conv + deconv


def test_mfu_of_the_generator_scales_with_area():
    from portbench.drivers.imitate import flops_per_frame
    from portbench.lib import manifest

    cfg = manifest.load_cell("imitate.attlwb_spade_512").config
    frame, setup = flops_per_frame(cfg)
    assert 280e9 < frame < 292e9  # about 286 GFLOP a frame at 512^2
    add = manifest.load_cell("imitate.addlwb_512").config
    assert 160e9 < flops_per_frame(add)[0] < 175e9 and setup > 0


def test_clip_lengths_keep_the_work_of_each_pair():
    for seed in (0, 7, 2 ** 31 + 11):
        lengths = clip_lengths({"min": 60, "max": 300}, seed, 40, 8)
        pairs = np.asarray(lengths).reshape(-1, 2)
        assert (pairs.sum(1) == 360).all() and all(60 <= x <= 300 for x in lengths)
        assert all(((-pairs) % 8).sum(1) == 8)  # one chunk of padding per pair
    assert clip_lengths({"min": 60, "max": 300}, 1, 10, 8) != clip_lengths({"min": 60, "max": 300}, 2, 10, 8)


def test_a_fixed_set_of_pairs_gives_every_seed_the_same_sizes_in_another_order():
    params = {"min": 60, "max": 300, "pairs": 21}
    cycles = {}
    for seed in (0, 7, 2 ** 31 + 11):
        lengths = clip_lengths(params, seed, 84, 4)
        pairs = np.asarray(lengths).reshape(-1, 2)
        assert (pairs.sum(1) == 360).all() and all(60 <= x <= 300 for x in lengths)
        assert all(((-pairs) % 4).sum(1) == 4)  # one card's worth of padding per pair
        first, second = sorted(lengths[:42]), sorted(lengths[42:])
        assert first == second == lengths_drawn(params, 4)
        cycles[seed] = lengths[:42]
    assert len({tuple(v) for v in cycles.values()}) == 3
    assert max(lengths_drawn(params, 4)) == 298 and min(lengths_drawn(params, 4)) == 62
    # a mix without the key draws any length that is no multiple of the chunk
    assert lengths_drawn({"min": 6, "max": 10}, 4) == [6, 7, 9, 10]


def test_requests_are_a_function_of_the_seed():
    params = {"clip_frames": {"min": 24, "max": 96}, "chunk": 8, "subject": "per_request",
              "motion": {"fps": 30, "joint_amplitude_rad": [0.05, 0.35], "joint_hz": [0.2, 1.2],
                         "turn_deg": 60, "turn_hz": [0.05, 0.3]}}
    a, b = Requests(params, 2 ** 31 + 5), Requests(params, 2 ** 31 + 5)
    assert [a.length(i) for i in range(6)] == [b.length(i) for i in range(6)]
    assert np.array_equal(a.clip(3), b.clip(3)) and a.clip(3).shape == (a.length(3), 85)
    assert a.subject_index(0) == 1 and 0 <= a.checked_chunk(2, 8) <= math.ceil(a.length(2) / 8) - 1
