"""``tools/profile_engine_cuda.py`` on the CPU against
``tools/profile_engine.py``.

* ``classify`` on a fixed list of CUDA kernel and copy names: the port's
  hand-written kernels under their own names, the JAX tool's groups for
  the rest (an elementwise kernel whose functor names a copy is a fusion).
* The attribution at 256x256, batch 2, one traced dispatch, on the CPU
  (the profiler's CPU operators stand in for device events): groups and
  top ops that sum to the total, and the JAX engine's grid.
* ``main`` prints the device line first and then the JAX tool's report
  headers; without a card it raises naming ``device='cpu'``."""
import importlib.util
from pathlib import Path

import pytest
import torch

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

NAMES = {
    "void (anonymous namespace)::shift_windows_kernel<1, float>(float const*, int const*)":
        "shift_windows",
    "void (anonymous namespace)::shift_windows_kernel<1, __nv_bfloat16>(float const*)":
        "shift_windows",
    "void (anonymous namespace)::shift_windows_bicubic_kernel<1, float>(float const*)":
        "shift_windows",
    "void (anonymous namespace)::def_windows_kernel<false, float>(float const*)":
        "def_windows",
    "void (anonymous namespace)::peakfit_warp_kernel<1, 32>(float const*)": "peakfit",
    "void (anonymous namespace)::corrfit_kernel<32>(float const*)": "corrfit",
    "void (anonymous namespace)::fused_pass_kernel<32>(float const*)": "fused_pass",
    "void regular_fft_factor<128u, EPT<8u>, 4u, 2u, (padding_t)0>(unsigned int)": "fft",
    "void vector_fft_r2c<512u, EPT<8u>>(unsigned int)": "fft",
    "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32": "matmul",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(Params)": "matmul",
    "Memcpy HtoD (Pageable -> Device)": "transfer",
    "Memcpy DtoH (Device -> Pinned)": "transfer",
    "Memcpy DtoD (Device -> Device)": "layout_copy",
    "Memset (Device)": "layout_copy",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int>(int)":
        "layout_copy",
    "void at::native::roll_cuda_kernel<float>(float const*, float*)": "layout_copy",
    "void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda"
    "(at::TensorIteratorBase&)::{lambda()#3}>(int)": "fusion",
    "void at::native::unrolled_elementwise_kernel<at::native::AUnaryFunctor<float>>(int)":
        "fusion",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl<...>>(int)":
        "fusion",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(at::native::ReduceOp)":
        "reduce",
    "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel>(long)":
        "gather_scatter",
    "void at::native::_scatter_gather_elementwise_kernel<128, 4>(int)": "gather_scatter",
    "void at::native::max_pool_forward_nchw<float>(int)": "other",
}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load("tools/profile_engine_cuda.py", "port_profile_engine")


def test_classify_cuda_names(tool):
    assert {name: tool.classify(name) for name in NAMES} == NAMES


@pytest.mark.parametrize("mode", ["CWS", "DEF"])
def test_attribution_adds_up_and_has_the_jax_grid(tool, mode):
    out = tool.profile_engine(CPU, mode=mode, reps=1, frame=(256, 256), batch=2)
    assert out["n_pairs"] == 2 and out["event_ms"] is None and len(out["dispatch_ms"]) == 2
    assert out["total_ms"] > 0
    assert sum(out["per_group"].values()) == pytest.approx(out["total_ms"])
    assert sum(out["per_op"].values()) == pytest.approx(out["total_ms"])
    want = JaxMultipassPIV(JaxPIVConfig(frame_shape=(256, 256), wind_size=64, overlap=32,
                                        multipass=2, multipass_mode=mode)).final_field_shape
    assert out["final_field_shape"] == tuple(want)


def test_main_prints_the_device_and_the_jax_report(tool, monkeypatch, capsys):
    monkeypatch.setattr(tool, "FRAME", (128, 128))
    monkeypatch.setattr(tool, "BATCH", 2)
    assert tool.main(["--device", "cpu", "--reps", "1", "--top", "5", "--mode", "dws"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    assert any(ln.startswith("== device op time: ") and ln.endswith(" ms/pair ==")
               for ln in lines)
    assert "-- by group (ms/pair) --" in lines
    i = lines.index("-- top 5 ops (ms/pair) --")
    assert len([ln for ln in lines[i + 1:] if ln.strip()]) == 5


def test_import_does_no_work_and_main_needs_a_card(tool, monkeypatch, capsys):
    monkeypatch.delenv("TPIV_DEVICE", raising=False)
    _load("tools/profile_engine_cuda.py", "port_profile_engine_again")
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
