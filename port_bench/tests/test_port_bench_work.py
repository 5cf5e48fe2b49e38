"""The benchmark's frozen work arithmetic reproduces the kernel table's
``bound`` column in PERF.md (every digit as printed), and the path sums."""
import pytest

from port_bench_tiny import ROOT  # noqa: F401  (puts the repository on the path)
from port_bench import work as W

TABLE = [
    ("flash mma BH=32 S=1024 D=64", W.flash(32, 1024, 1024, 64, True, 2), 2, "0.0050", "bytes"),
    ("flash mma MLA", W.flash(16, 1024, 1024, 192, True, 2, Dv=128), 2, "0.0063", "bytes"),
    ("flash mma HuBERT", W.flash(128, 1500, 1500, 80, False, 2), 2, "0.0932", "operations"),
    ("flash mma train", W.flash(128, 1024, 1024, 64, True, 2), 2, "0.0200", "bytes"),
    ("flash cuda_core f32", W.flash(32, 1024, 1024, 64, True, 4), 4, "0.0642", "operations"),
    ("swiglu decode", W.swiglu(8, 2048, 5632, 2), 2, "0.0138", "bytes"),
    ("swiglu decode 4096", W.swiglu(8, 4096, 14336, 2), 2, "0.0702", "bytes"),
    ("swiglu decode 7168", W.swiglu(8, 7168, 4864, 2), 2, "0.0417", "bytes"),
    ("swiglu wgmma", W.swiglu(512, 2048, 5632, 2), 2, "0.0239", "operations"),
    ("swiglu wgmma 4096", W.swiglu(1024, 4096, 14336, 2), 2, "0.2432", "operations"),
    ("swiglu wgmma HuBERT", W.swiglu(12000, 1280, 5120, 2), 2, "0.3181", "operations"),
    ("swiglu wgmma 7168", W.swiglu(1024, 7168, 4864, 2), 2, "0.1444", "operations"),
    ("swiglu wgmma train", W.swiglu(4096, 2048, 5632, 2), 2, "0.1911", "operations"),
    ("swiglu cuda_core f32", W.swiglu(512, 2048, 5632, 4), 4, "0.3526", "operations"),
    ("experts_wgmma", W.swiglu(120, 2048, 1408, 2, E=64), 2, "0.2362", "bytes"),
    ("experts_wgmma Jamba", W.swiglu(160, 4096, 14336, 2, E=16), 2, "1.1500", "bytes"),
    ("experts_decode", W.swiglu(8, 2048, 1408, 2, E=64), 2, "0.2214", "bytes"),
    ("experts_decode Jamba", W.swiglu(8, 4096, 14336, 2, E=16), 2, "1.1232", "bytes"),
    ("experts_decode Arctic prefill", W.swiglu(20, 7168, 4864, 2, E=128), 2, "5.3470", "bytes"),
    ("experts_decode Arctic tick", W.swiglu(8, 7168, 4864, 2, E=128), 2, "5.3360", "bytes"),
    ("experts_cuda_core f32", W.swiglu(120, 2048, 1408, 4, E=64), 4, "1.3221", "operations"),
    ("ssd wgmma flat", W.ssd(32, 32, 1024, 64, 128, 2), 2, "0.0079", "bytes"),
    ("ssd wgmma mamba2 layout", W.ssd(32, 1, 1024, 64, 128, 2), 2, "0.0030", "bytes"),
    ("ssd wgmma Jamba layout", W.ssd(128, 1, 1024, 64, 16, 2), 2, "0.0103", "bytes"),
    ("ssd wgmma train layout", W.ssd(128, 4, 1024, 64, 128, 2), 2, "0.0121", "bytes"),
    ("ssd cuda_core f32", W.ssd(32, 32, 1024, 64, 128, 4, 32), 4, "0.0191", "operations"),
    ("ssd wgmma_bwd train layout", W.ssd_bwd(128, 4, 1024, 64, 128, 2), 2, "0.0166", "bytes"),
    ("ssd wgmma_bwd Jamba train layout", W.ssd_bwd(256, 2, 1024, 64, 16, 2), 2, "0.0308",
     "bytes"),
    ("flash wgmma_bwd train", W.flash_bwd(128, 1024, 1024, 64, True, 2), 2, "0.0435",
     "operations"),
    ("swiglu wgmma_bwd train", W.swiglu_bwd(4096, 2048, 5632, 2), 2, "0.1911", "operations"),
]


@pytest.mark.parametrize("name,work,elem,printed,by", TABLE, ids=[r[0] for r in TABLE])
def test_bounds_read_as_the_kernel_table_prints(name, work, elem, printed, by):
    ms, bound_by = W.bound_ms(*work, elem)
    assert (f"{ms:.4f}", bound_by) == (printed, by)


@pytest.mark.parametrize("Sq,Sk", [(1, 1), (7, 7), (100, 130), (130, 100), (1024, 1024),
                                   (3, 40), (40, 3), (0, 5), (5, 0)])
def test_causal_pairs_count_each_query_row(Sq, Sk):
    assert W.causal_pairs(Sq, Sk) == sum(min(Sk, max(0, i + Sk - Sq + 1)) for i in range(Sq))


def test_experts_count_routed_rows():
    """Routed rows spread evenly over the experts read as the per-expert form."""
    assert W.experts(16 * 160, 16, 4096, 14336, 2) == W.swiglu(160, 4096, 14336, 2, E=16)


def test_path_sums():
    import json

    arch = json.loads((ROOT / "port_bench/configs/jamba-v0.1-52b-16L.json").read_text())["arch"]
    from port_bench.archcfg import layer_kinds

    kinds = layer_kinds(arch)
    assert [k for k in kinds[:8]] == [("ssm", "dense"), ("ssm", "moe"), ("ssm", "dense"),
                                      ("ssm", "moe"), ("attn", "dense"), ("ssm", "moe"),
                                      ("ssm", "dense"), ("ssm", "moe")]
    L = 2048
    want = (14 * W.bound_ms(*W.ssd(128, 1, L, 64, 16, 2), 2)[0]
            + 2 * W.bound_ms(*W.flash(32, L, L, 128, True, 2), 2)[0]
            + 8 * W.bound_ms(*W.swiglu(L, 4096, 14336, 2), 2)[0]
            + 8 * W.bound_ms(*W.experts(2 * L, 16, 4096, 14336, 2), 2)[0])
    prefill = W.tick_work(arch, kinds, [L], 0)
    assert {f: c for f, (c, _) in prefill.items()} == {"ssd": 14, "flash": 2, "swiglu": 8,
                                                       "experts": 8}
    assert sum(ms for _, ms in prefill.values()) == pytest.approx(want, rel=1e-12)
    decode = W.tick_work(arch, kinds, [], 16)
    assert {f: c for f, (c, _) in decode.items()} == {"swiglu": 8, "experts": 8}
    assert sum(ms for _, ms in decode.values()) == pytest.approx(
        8 * W.bound_ms(*W.swiglu(16, 4096, 14336, 2), 2)[0]
        + 8 * W.bound_ms(*W.experts(32, 16, 4096, 14336, 2), 2)[0], rel=1e-12)
    both = W.tick_work(arch, kinds, [L], 16)
    assert both["experts"][0] == 16 and both["experts"][1] == pytest.approx(
        prefill["experts"][1] + decode["experts"][1], rel=1e-12)
