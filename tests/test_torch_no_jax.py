"""The PyTorch port stands alone: importing every module of
``incubator_mxnet_tpu_torch`` pulls in neither JAX nor the JAX package,
and no source file of the port names either. The import check runs in a
fresh interpreter, since this test process has JAX loaded already."""
import json
import subprocess
import sys
from pathlib import Path

import incubator_mxnet_tpu_torch

PKG_DIR = Path(incubator_mxnet_tpu_torch.__file__).resolve().parent
REPO = PKG_DIR.parent

_PROBE = """
import importlib, json, pkgutil, sys
import incubator_mxnet_tpu_torch as pkg
from incubator_mxnet_tpu_torch import operator, registry, rtc, test_utils
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "incubator_mxnet_tpu"
             or m.startswith("incubator_mxnet_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "incubator_mxnet_tpu_torch.serving" in res["modules"]
    assert "incubator_mxnet_tpu_torch.ops.cuda.flash_attention" in \
        res["modules"]
    assert "incubator_mxnet_tpu_torch.parallel.moe" in res["modules"]
    for name in ("base", "context", "engine", "autograd", "random",
                 "initializer", "ndarray", "ndarray.ndarray", "ndarray.ops",
                 "ndarray.optimizer_ops", "ops.nn", "ops.cuda.layer_norm",
                 "ops.cuda.softmax", "models.nd_lm", "name", "gluon",
                 "gluon.block", "gluon.parameter", "gluon.nn",
                 "gluon.nn.basic_layers", "gluon.nn.conv_layers",
                 "gluon.loss", "gluon.utils", "gluon.trainer",
                 "gluon.model_zoo", "gluon.model_zoo.vision",
                 "gluon.model_zoo.vision.resnet",
                 "gluon.model_zoo.vision._fused_resnet", "optimizer",
                 "optimizer.optimizer", "lr_scheduler", "parallel.dp",
                 "ops.cuda.conv_fused", "ops.cuda.lstm", "ops.rnn",
                 "gluon.rnn", "gluon.rnn.rnn_layer", "gluon.rnn.rnn_cell",
                 "models.word_lm", "metric", "ops.detection",
                 "ops.cuda.detection", "ndarray.contrib", "models.ssd",
                 "gluon.model_zoo.vision.vgg", "rtc", "operator",
                 "test_utils", "registry", "ops.cuda.nvrtc", "cuda_graph",
                 "guard", "callback", "contrib", "contrib.quantization",
                 "ops.quantization", "ops.cuda.quantized", "tools",
                 "tools.serve", "gluon.model_zoo.vision.quantized",
                 "_native", "recordio", "io", "_recdecode", "image",
                 "image.image", "image.device", "ndarray.image",
                 "gluon.data", "gluon.data.dataset", "gluon.data.sampler",
                 "gluon.data.dataloader", "_dataloader_worker",
                 "gluon.data.vision", "gluon.data.vision.datasets",
                 "gluon.data.vision.transforms", "image.detection",
                 "elastic", "input_service",
                 "gluon.model_zoo.vision.alexnet",
                 "gluon.model_zoo.vision.densenet",
                 "gluon.model_zoo.vision.squeezenet",
                 "gluon.model_zoo.vision.inception",
                 "gluon.model_zoo.vision.mobilenet", "contrib.text",
                 "gluon.contrib", "gluon.contrib.data",
                 "gluon.contrib.data.sampler", "gluon.contrib.data.text",
                 "rnn", "rnn.io", "util", "log", "misc", "libinfo",
                 "ndarray.sparse", "ndarray.linalg", "optimizer.fused",
                 "ops.cuda.multi_tensor", "gluon.contrib.nn",
                 "gluon.contrib.nn.basic_layers", "gluon.contrib.rnn",
                 "gluon.contrib.rnn.rnn_cell",
                 "gluon.contrib.rnn.conv_rnn_cell", "contrib.autograd",
                 "contrib.io", "contrib.ndarray", "contrib.tensorboard",
                 "parallel.mesh", "parallel.collectives",
                 "parallel.ring_attention", "parallel.ulysses",
                 "parallel.tp", "parallel.pipeline", "parallel.world",
                 "tools.launch", "parallel.embedding",
                 "models.sparse_recommenders", "kvstore", "_ps",
                 "kvstore_server", "fault"):
        assert f"incubator_mxnet_tpu_torch.{name}" in res["modules"], name
    assert res["bad"] == []


def test_port_sources_name_neither_jax_nor_the_jax_package():
    files = [f for ext in ("py", "cu", "cuh", "cpp")
             for f in sorted(PKG_DIR.rglob(f"*.{ext}"))]
    assert len(files) > 10
    assert PKG_DIR / "ops" / "cuda" / "csrc" / "rows.cuh" in files
    assert PKG_DIR / "ops" / "cuda" / "csrc" / "lstm.cu" in files
    assert PKG_DIR / "ops" / "cuda" / "csrc" / "detection.cu" in files
    assert PKG_DIR / "ops" / "cuda" / "csrc" / "quantized.cu" in files
    assert PKG_DIR / "ops" / "cuda" / "csrc" / "multi_tensor.cu" in files
    assert PKG_DIR / "contrib" / "quantization.py" in files
    assert PKG_DIR / "tools" / "serve.py" in files
    assert PKG_DIR / "io.py" in files
    assert PKG_DIR / "gluon" / "data" / "dataloader.py" in files
    for rel in (("image", "detection.py"), ("input_service.py",),
                ("elastic.py",), ("contrib", "text.py"),
                ("gluon", "contrib", "data", "text.py"), ("rnn", "io.py"),
                ("gluon", "model_zoo", "vision", "inception.py"),
                ("parallel", "mesh.py"), ("parallel", "collectives.py"),
                ("parallel", "ulysses.py"), ("parallel", "tp.py"),
                ("parallel", "pipeline.py"), ("parallel", "world.py"),
                ("tools", "launch.py"), ("parallel", "embedding.py"),
                ("models", "sparse_recommenders.py"), ("kvstore.py",),
                ("_ps.py",), ("kvstore_server.py",), ("fault.py",)):
        assert PKG_DIR.joinpath(*rel) in files, rel
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        assert "from jax" not in text, f
        assert "incubator_mxnet_tpu." not in text, f
