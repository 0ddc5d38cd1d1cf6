"""rtc (runtime-compiled CUDA kernels) of the PyTorch port, on the CPU.

This box has no NVRTC and no card, so the CUDA path itself runs only in
``chip_smoke.py`` phase 23. Here: MXNet's signature parsing, the launch's
argument checks (through the parser and the checker directly), the
module's export lookup with compilation stubbed out, the errors without a
card or NVRTC, ``PallasModule`` raising, and the link between the card's
check and the reference: the JAX package's ``PallasModule`` axpy (interpret
mode, as ``tests/test_monitor_rtc_tools.py`` runs it) equals the plain
twin that ``chip_smoke.py`` holds the CUDA axpy to, with tolerance 0.
"""
import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import rtc
from incubator_mxnet_tpu_torch.ops.cuda import launch_counts, nvrtc

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")


def _nd(a):
    return tmx.nd.array(a, ctx=tmx.cpu())


# ------------------------------------------------------------- signatures
@pytest.mark.parametrize("ctype,np_type", [
    ("float", np.float32), ("double", np.float64), ("__half", np.float16),
    ("uint8_t", np.uint8), ("int", np.int32), ("int32_t", np.int32),
    ("int8_t", np.int8), ("char", np.int8), ("int64_t", np.int64)])
def test_signature_types(ctype, np_type):
    specs = rtc.parse_signature(f"const {ctype} *x, {ctype} *y, {ctype} n, "
                                f"const {ctype} m")
    assert [s.dtype for s in specs] == [np.dtype(np_type)] * 4
    assert [s.is_ndarray for s in specs] == [True, True, False, False]
    assert [s.is_const for s in specs] == [True, False, False, True]
    assert [s.name for s in specs] == ["x", "y", "n", "m"]


def test_signature_spacing_and_unnamed_arguments():
    specs = rtc.parse_signature("const float*,float *  , \n const int,int")
    assert [(s.is_const, s.is_ndarray, s.name) for s in specs] == [
        (True, True, ""), (False, True, ""), (True, False, ""),
        (False, False, "")]
    specs = rtc.parse_signature(chip_smoke.SOFTMAX_BWD_SIGNATURE)
    assert [s.is_ndarray for s in specs] == [True, True, True, False, False]


@pytest.mark.parametrize("sig", ["const *x", "float **x", "float x y",
                                 "const", "", "float *x,", "float[] x"])
def test_signature_malformed_raises(sig):
    with pytest.raises(ValueError, match="Invalid function prototype"):
        rtc.parse_signature(sig)


@pytest.mark.parametrize("sig", ["half *x", "float *x, long n",
                                 "unsigned *x", "float16 *x"])
def test_signature_unsupported_type_raises(sig):
    with pytest.raises(TypeError, match="Unsupported kernel argument type"):
        rtc.parse_signature(sig)


# ------------------------------------------------------- argument checks
AXPY = rtc.parse_signature(chip_smoke.AXPY_SIGNATURE)


def test_pack_arguments_widths_and_pointers():
    specs = rtc.parse_signature("const float *x, float *y, int a, "
                                "int64_t b, float c, double d, __half e, "
                                "uint8_t f, char g")
    x, y = _nd(np.ones(4, np.float32)), _nd(np.zeros(4, np.float32))
    params, (values, tensors) = rtc.pack_arguments(
        specs, [x, y, 3, 2 ** 40, 1.5, 2.25, 0.5, 255, -3], CPU, "k")
    assert len(params) == 9
    # kernelParams: each entry points at the storage of one argument
    for i, t in enumerate((x, y)):
        assert ctypes.c_void_p.from_address(params[i]).value == \
            t._data.data_ptr()
    assert [params[i] for i in range(2, 9)] == [v.ctypes.data
                                                for v in values[2:]]
    assert [v.itemsize for v in values[2:]] == [4, 8, 4, 8, 2, 1, 1]
    assert [v.item() for v in values[2:]] == [3, 2 ** 40, 1.5, 2.25, 0.5,
                                              255, -3]
    assert tensors[0] is x._data and tensors[1] is y._data


def test_pack_arguments_count():
    x = _nd(np.ones(4, np.float32))
    with pytest.raises(ValueError, match=r"expects 4 arguments but got 3"):
        rtc.pack_arguments(AXPY, [x, x, x], CPU, "axpy")


def test_pack_arguments_types():
    x = _nd(np.ones(4, np.float32))
    with pytest.raises(TypeError, match="argument 1 is expected to be "
                       "float32, got float16"):
        rtc.pack_arguments(AXPY, [x, _nd(np.ones(4, np.float16)), x, 4],
                           CPU, "axpy")
    with pytest.raises(TypeError, match="argument 0 is expected to be an "
                       "NDArray"):
        rtc.pack_arguments(AXPY, [np.ones(4, np.float32), x, x, 4], CPU,
                           "axpy")
    with pytest.raises(TypeError, match="argument 3 is expected to be a "
                       "number, got NDArray"):
        rtc.pack_arguments(AXPY, [x, x, x, x], CPU, "axpy")
    for bad in (True, "4", None, torch.tensor(4)):
        with pytest.raises(TypeError, match="argument 3"):
            rtc.pack_arguments(AXPY, [x, x, x, bad], CPU, "axpy")
    with pytest.raises(TypeError, match=r"argument 3 is an integer"):
        rtc.pack_arguments(AXPY, [x, x, x, 4.5], CPU, "axpy")
    rtc.pack_arguments(AXPY, [x, x, x, np.int64(4)], CPU, "axpy")
    rtc.pack_arguments(AXPY, [x, x, x, 4.0], CPU, "axpy")


def test_pack_arguments_device():
    x = _nd(np.ones(4, np.float32))
    with pytest.raises(ValueError, match=r"argument 0 is on cpu\(0\), the "
                       r"launch on gpu\(0\)"):
        rtc.pack_arguments(AXPY, [x, x, x, 4], torch.device("cuda", 0),
                           "axpy")


def test_pack_arguments_contiguity():
    base = _nd(np.arange(16, dtype=np.float32).reshape(4, 4))
    strided = base.T
    assert not strided._data.is_contiguous()
    out = _nd(np.zeros((4, 4), np.float32))
    # a read-only argument is made contiguous (and kept alive)
    _, (_, tensors) = rtc.pack_arguments(AXPY, [strided, base, out, 16],
                                         CPU, "axpy")
    assert tensors[0].is_contiguous()
    np.testing.assert_array_equal(tensors[0].numpy(),
                                  np.arange(16).reshape(4, 4).T)
    # a written one would be written through a copy: refused
    with pytest.raises(ValueError, match="argument 2 is written by the "
                       "kernel and is not contiguous"):
        rtc.pack_arguments(AXPY, [base, base, strided, 16], CPU, "axpy")


@pytest.mark.parametrize("dims", [(), (0,), (1, 2, 3, 4), (2, -1)])
def test_launch_dims_checked(dims):
    with pytest.raises(ValueError, match="grid_dims"):
        rtc._dims(dims, "grid_dims")


def test_launch_dims_padded():
    assert rtc._dims((7,), "g") == (7, 1, 1)
    assert rtc._dims([2, 3], "g") == (2, 3, 1)


# --------------------------------------------- module with NVRTC stubbed
@pytest.fixture
def stub_module(monkeypatch):
    """CudaModule with the card and NVRTC stubbed out: everything up to
    the driver calls runs here."""
    calls = {}

    def compile_cubin(source, names, options, arch):
        calls.update(source=source, names=tuple(names),
                     options=tuple(options), arch=arch)
        return b"cubin", {n: f"_lowered_{n}" for n in names}, ""

    monkeypatch.setattr(rtc, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(nvrtc, "card_arch", lambda dev: "sm_90a")
    monkeypatch.setattr(nvrtc, "compile_cubin", compile_cubin)
    mod = rtc.CudaModule(chip_smoke.SOFTMAX_SRC, options="--use_fast_math",
                         exports=list(chip_smoke.SOFTMAX_EXPORTS))
    return mod, calls


def test_module_compiles_every_export(stub_module):
    mod, calls = stub_module
    assert calls["names"] == chip_smoke.SOFTMAX_EXPORTS
    assert calls["options"] == ("--use_fast_math",)
    assert calls["arch"] == "sm_90a"
    assert mod.compile_ms >= 0
    k = mod.get_kernel("softmax_fwd<float>",
                       chip_smoke.SOFTMAX_FWD_SIGNATURE)
    assert isinstance(k, rtc.CudaKernel) and k.launches == 0
    assert [s.is_ndarray for s in k.signature] == [True, True, False, False]


def test_get_kernel_of_a_missing_export(stub_module):
    mod, _ = stub_module
    with pytest.raises(ValueError, match="not among the module's exports"):
        mod.get_kernel("softmax_fwd<double>", "const double *x")
    with pytest.raises(ValueError, match="not among the module's exports"):
        mod.get_kernel("missing", "float *x")


def test_launch_refuses_a_cpu_context(stub_module):
    mod, _ = stub_module
    k = mod.get_kernel("softmax_fwd<float>",
                       chip_smoke.SOFTMAX_FWD_SIGNATURE)
    x = _nd(np.ones((2, 3), np.float32))
    for ctx in (tmx.cpu(), "gpu"):
        with pytest.raises(ValueError, match="GPU context"):
            k.launch([x, x, 3, 1], ctx, (2,), (32,))
    assert k.launches == 0 and launch_counts()["rtc_launch"] == 0


def test_call_form_checks(stub_module):
    mod, _ = stub_module
    sig = chip_smoke.SOFTMAX_FWD_SIGNATURE
    with pytest.raises(ValueError, match="need out_like or out_shape"):
        mod.get_kernel("softmax_fwd<float>", sig, grid_dims=(1,),
                       block_dims=(32,))
    with pytest.raises(ValueError, match="grid_dims and block_dims"):
        mod.get_kernel("softmax_fwd<float>", sig, out_like=0)
    with pytest.raises(ValueError, match="exactly one non-const pointer"):
        mod.get_kernel("softmax_fwd<float>", "float *x, float *y, int n, "
                       "int r", out_like=0, grid_dims=(1,), block_dims=(1,))
    call = mod.get_kernel("softmax_fwd<float>", sig, out_like=0,
                          grid_dims=lambda x, n, r: (x.shape[0],),
                          block_dims=(32,))
    assert call.kernel.name == "softmax_fwd<float>"
    x = _nd(np.ones((2, 3), np.float32))
    with pytest.raises(ValueError, match="GPU context"):
        call(x, 3, 1)


# ------------------------------------------------------ no card, no NVRTC
def test_cuda_module_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 23 covers it")
    with pytest.raises(tmx.NoCudaDeviceError):
        rtc.CudaModule(chip_smoke.AXPY_SRC, exports=["axpy"])


def test_missing_nvrtc_lists_the_paths_searched(monkeypatch, tmp_path):
    empty = tmp_path / "lib64"
    empty.mkdir()
    monkeypatch.setattr(nvrtc, "_nvrtc_lib", None)
    monkeypatch.setattr(nvrtc, "nvrtc_search_dirs",
                        lambda: [empty, tmp_path / "absent"])
    monkeypatch.setattr(nvrtc, "_SONAMES", ("libnvrtc-not-here.so.0",))
    with pytest.raises(nvrtc.NvrtcNotFoundError) as err:
        nvrtc.nvrtc_version()
    for p in (str(empty), str(tmp_path / "absent"),
              "libnvrtc-not-here.so.0"):
        assert p in str(err.value)


def test_search_dirs_cover_the_toolkit_and_the_wheel():
    dirs = [str(d) for d in nvrtc.nvrtc_search_dirs()]
    assert "/usr/local/cuda/lib64" in dirs
    assert dirs[-1].endswith("torch/lib")


def test_pallas_module_raises_naming_the_jax_package():
    with pytest.raises(NotImplementedError, match="JAX package"):
        rtc.PallasModule("def k(x_ref, o_ref): pass", exports=["k"])
    assert tmx.rtc.CudaModule is rtc.CudaModule
    assert "rtc_launch" in launch_counts()


# ------------------------------------------ the axpy: reference vs twin
@pytest.mark.parametrize("shape", [(2, 4), (8, 128), (1000,)])
def test_reference_pallas_axpy_equals_the_cards_twin(shape):
    """The JAX package's PallasModule axpy (interpret mode) equals
    chip_smoke.axpy_twin, which the CUDA axpy is held to on the card."""
    rs = np.random.default_rng(7)
    x = rs.standard_normal(shape).astype(np.float32)
    y = rs.standard_normal(shape).astype(np.float32)
    src = """
def axpy_kernel(x_ref, y_ref, o_ref):
    o_ref[...] = 2.0 * x_ref[...] + y_ref[...]
"""
    mod = jmx.rtc.PallasModule(src, exports=["axpy_kernel"])
    k = mod.get_kernel("axpy_kernel", out_like=0)
    ref = k(jmx.nd.array(x), jmx.nd.array(y)).asnumpy()
    twin = chip_smoke.axpy_twin(torch.from_numpy(x),
                                torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(ref, twin)


def test_softmax_twins_are_the_reference_functions():
    """The rtc softmax twins compute the softmax output layer: the forward
    is the JAX package's nd.softmax and the backward prob - onehot."""
    rs = np.random.default_rng(3)
    x = (3 * rs.standard_normal((64, 10))).astype(np.float32)
    label = rs.integers(0, 10, 64).astype(np.float32)
    y = chip_smoke.softmax_fwd_twin(torch.from_numpy(x))
    import jax
    with jax.default_matmul_precision("highest"):
        want = jmx.nd.softmax(jmx.nd.array(x), axis=1).asnumpy()
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-7)
    g = chip_smoke.softmax_bwd_twin(torch.from_numpy(label), y).numpy()
    hot = np.eye(10, dtype=np.float32)[label.astype(int)]
    np.testing.assert_array_equal(g, y.numpy() - hot)
    assert chip_smoke.row_block(10) == 32
    assert chip_smoke.row_block(33278) == 512
    assert chip_smoke.row_block(33) == 64
