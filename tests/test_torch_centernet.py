"""The port's ctdet DLA-34 inference path against the JAX package, at a small
width (CHANNELS [8, 8, 16, 16, 32, 32], HEAD_CONV 16, 4 classes, 64x64).

One random variables tree, made with numpy from a seed, goes to both: as it is
to the JAX model, through ``state_dict_from_jax`` to the port. JAX runs on the
CPU in f32 with ``TEST.EXACT_MODE`` (exact DCN, exact top-k, f32 scores); the
port runs on the CPU (``MODEL.DEVICE=cpu``) in f32, where every DCN takes the
plain version.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.engine import DefaultPredictor as JaxPredictor
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.ops.decode import ctdet_decode as jax_decode
from detectron2_centernet_tpu_torch.checkpoint import canonical_dla_key, state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import warp_image
from detectron2_centernet_tpu_torch.engine import DefaultPredictor
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.ops import ctdet_decode, cuda_lib, dcn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "COCO-Detection", "ctdet_dla_34_1x.yaml")
SIZE = 64


def _small(cfg):
    cfg.merge_from_file(YAML)
    cfg.merge_from_list([
        "MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32],
        "MODEL.CENTERNET.HEAD_CONV", 16,
        "MODEL.CENTERNET.TASK.HM", 4,
        "DATASETS.TRAIN", (),
        "INPUT.TEST_SIZE", (SIZE, SIZE),
        "TPU.DTYPE", "float32",
        "TEST.EXACT_MODE", True,
    ])
    return cfg


def _port_cfg():
    cfg = _small(get_cfg())
    cfg.MODEL.DEVICE = "cpu"
    return cfg


def _random_variables(shapes, seed):
    """A variables tree with the leaf shapes of ``shapes``, every leaf
    random: kernels N(0, 1/fan_in), the offset convs scaled so offsets reach a
    few pixels, BN statistics and affine away from identity."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            if "conv_offset_mask" in path:
                a = a * 2.0
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif path[-2] == "hm_out":
            a = -2.19 + rng.randn(*v.shape) * 0.5
        else:  # bias, mean
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


@pytest.fixture(scope="module")
def models():
    """(JAX CenterNet, its variables, the port's CenterNet) sharing weights."""
    jm = jax_build_model(_small(jax_get_cfg()))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed=0)
    pm = build_model(_port_cfg())
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


def _images(n, seed):
    return np.random.RandomState(seed).uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)


def test_state_dict_from_jax_covers_every_leaf_once(models):
    jm, variables, pm = models
    sd = state_dict_from_jax(variables)
    leaves = {"/".join(p) for p in flatten_dict(variables)}
    assert set(sd) == set(pm.model.state_dict())
    mapped = [canonical_dla_key(k) for k in sd if not k.endswith("num_batches_tracked")]
    assert len(mapped) == len(set(mapped)) == len(leaves)
    assert set(mapped) == leaves
    for key, t in pm.model.state_dict().items():
        assert t.shape == sd[key].shape, key


def test_dla34_stride4_map_matches_jax(models):
    """The (N, 16, 16, 16) stride-4 feature; f32 through ~40 layers and 16
    DCNs, 1e-4 relative to the map's scale."""
    jm, variables, pm = models
    x = _images(2, seed=1)
    xn = np.asarray(jm.normalize(jnp.asarray(x)))
    want = np.asarray(jm.backbone.apply(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]}, jnp.asarray(xn)))
    with torch.no_grad():
        got = pm.model.backbone(torch.from_numpy(xn.transpose(0, 3, 1, 2).copy()))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, SIZE // 4, SIZE // 4, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _above(dets, i, thresh):
    keep = dets["scores"][i] > thresh
    return {k: v[i][keep] for k, v in dets.items()}


def test_predict_fn_matches_jax(models):
    """Detections above SCORE_THRESH_TEST: the same classes, scores within
    1e-5, boxes within 1e-3 px (random weights give distinct scores)."""
    jm, variables, pm = models
    x = _images(2, seed=2)
    want = {k: np.asarray(v) for k, v in jm.predict_fn(variables, jnp.asarray(x)).items()}
    dets = pm.predict_fn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = {k: v.numpy() for k, v in dets.items()}
    for i in range(2):
        w, g = _above(want, i, pm.score_threshold), _above(got, i, pm.score_threshold)
        assert len(w["scores"]) > 10
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3)


def test_default_predictor_matches_jax(models, monkeypatch):
    """One BGR uint8 image end to end. The JAX predictor warps with cv2, the
    port without it; both are fed the port's warped array here so the test
    holds the model and the host boundary. Boxes within 1e-2 px in the
    original image's pixels, scores within 1e-5."""
    jm, variables, pm = models
    cfg = _port_cfg()
    port = DefaultPredictor(cfg)
    port.model.model.load_state_dict(state_dict_from_jax(variables))
    monkeypatch.setattr(type(jm), "init", lambda self, rng, size: variables)  # skip a slow init
    ref = JaxPredictor(_small(jax_get_cfg()))
    ref._warp_image = lambda img, m, size: warp_image(img, m, size).numpy()
    img = np.random.RandomState(3).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    before = dcn.modulated_deform_conv.launches
    got = port(img)["instances"]
    assert dcn.modulated_deform_conv.launches == before  # CPU: no kernel launch
    want = ref(img)["instances"]
    assert got.image_size == want.image_size == (50, 70)
    assert len(got) == len(want) > 10
    np.testing.assert_array_equal(got.pred_classes, want.pred_classes)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.pred_boxes.tensor, np.asarray(want.pred_boxes.tensor), atol=1e-2)


def test_default_predictor_loads_model_weights(models, tmp_path):
    """MODEL.WEIGHTS: a torch checkpoint with the reference's keys, wrapped
    under "model" and with a DataParallel "module." prefix, loads key for key."""
    jm, variables, pm = models
    sd = state_dict_from_jax(variables)
    path = tmp_path / "ctdet.pth"
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
    cfg = _port_cfg()
    cfg.MODEL.WEIGHTS = str(path)
    loaded = DefaultPredictor(cfg).model.model.state_dict()
    assert set(loaded) == set(sd)
    for k, v in loaded.items():
        assert torch.equal(v, sd[k]), k


def test_default_predictor_rgb_format_flips_channels(models):
    """INPUT.FORMAT=RGB: the predictor takes BGR images and hands the model
    reversed channels, so it equals a BGR predictor fed the reversed image."""
    jm, variables, pm = models
    sd = state_dict_from_jax(variables)
    out = {}
    for fmt in ("BGR", "RGB"):
        cfg = _port_cfg()
        cfg.INPUT.FORMAT = fmt
        p = DefaultPredictor(cfg)
        p.model.model.load_state_dict(sd)
        out[fmt] = p
    img = np.random.RandomState(5).randint(0, 256, (40, 56, 3)).astype(np.uint8)
    got = out["RGB"](img)["instances"]
    want = out["BGR"](img[:, :, ::-1])["instances"]
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.pred_boxes.tensor, want.pred_boxes.tensor)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_ctdet_decode_matches_jax():
    """Distinct scores (a permutation), so the whole top-k agrees, ties and
    all; plateaus of equal neighbours are suppressed the same way."""
    rng = np.random.RandomState(4)
    n, c, h, w, k = 2, 3, 12, 10, 20
    hm = (rng.permutation(n * c * h * w).reshape(n, h, w, c) + 1.0) / (n * c * h * w + 1)
    hm = hm.astype(np.float32)
    hm[0, 2:4, 3:5, 1] = 1.0  # a plateau above every other score: all four survive
    wh = rng.uniform(1, 8, (n, h, w, 2)).astype(np.float32)
    reg = rng.uniform(0, 1, (n, h, w, 2)).astype(np.float32)
    want = [np.asarray(a) for a in jax_decode(jnp.asarray(hm), jnp.asarray(wh), jnp.asarray(reg), k=k)]
    t = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    got = [a.numpy() for a in ctdet_decode(t(hm), t(wh), t(reg), k=k)]
    top = slice(4, None)  # the plateau's four equal scores may come in any order
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2][:, top], want[2][:, top])
    np.testing.assert_allclose(got[0][:, top], want[0][:, top], atol=1e-5)
    assert sorted(map(tuple, got[0][0, :4])) == sorted(map(tuple, want[0][0, :4]))


def test_port_config_tree_equals_jax_defaults():
    """The copied defaults tree equals the JAX package's key by key, and the
    ctdet DLA-34 YAML merges into both alike."""
    def flat(node, prefix=""):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out.update(flat(val, prefix + key + "."))
            else:
                out[prefix + key] = val
        return out
    assert flat(get_cfg()) == flat(jax_get_cfg())
    a, b = get_cfg(), jax_get_cfg()
    a.merge_from_file(YAML)
    b.merge_from_file(YAML)
    assert flat(a) == flat(b)
    assert a.MODEL.BACKBONE.NAME == "build_dla34_backbone" and a.TEST.BATCH_SIZE == 16


def test_cuda_device_without_a_card_raises():
    """MODEL.DEVICE=cuda (the default) with no card raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("there is a card: nothing falls back here")
    cfg = _small(get_cfg())
    with pytest.raises(RuntimeError, match="MODEL.DEVICE"):
        build_model(cfg)


def test_port_imports_no_jax():
    """No file of the port, and not chip_smoke.py, names jax, flax, the JAX
    package, cv2, pycocotools or PyYAML in an import; importing every port
    module in a fresh interpreter loads none of them (the card's machine has
    none of them: the port keeps its own fill, resizes, RLE and YAML reader)."""
    pkg = os.path.join(REPO, "detectron2_centernet_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    banned = ("jax", "flax", "detectron2_centernet_tpu", "cv2", "pycocotools", "yaml")
    for path in files:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0].rstrip(",")
                    assert top not in banned, f"{path}: {line.strip()}"
    code = (
        "import importlib, pkgutil, sys\n"
        "import detectron2_centernet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'detectron2_centernet_tpu', 'cv2', 'pycocotools', 'yaml')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_port_builds_only_its_own_sources(tmp_path, monkeypatch):
    """Every source the port compiles lies inside the port: the argument
    lists that ``ops/cuda_lib.py::build_libraries`` hands nvcc (run here with a
    stand-in for nvcc, which the CPU machine lacks) and that
    ``ops/fast_cocoeval.py::build_library`` hands g++ (run for real) name
    sources under ``detectron2_centernet_tpu_torch/`` and nothing of the JAX
    package. The library g++ built then evaluates the oracle case of
    ``tests/evaluation/test_cocoeval_oracle.py`` as the numpy COCOEval does."""
    import importlib.util
    import pathlib
    import shlex

    from detectron2_centernet_tpu_torch.evaluation import COCOEval
    from detectron2_centernet_tpu_torch.ops import fast_cocoeval

    port = pathlib.Path(REPO, "detectron2_centernet_tpu_torch").resolve()
    commands = []

    class FakeNvcc:
        def __init__(self, argv, **kw):
            commands.append(list(argv))
            pathlib.Path(argv[argv.index("-o") + 1]).write_bytes(b"")
            self.returncode = 0

        def communicate(self):
            return "", ""

    with monkeypatch.context() as m:  # Popen is the subprocess module's: undone before g++ runs
        m.setattr(cuda_lib, "BUILD_DIR", tmp_path / "cuda")
        m.setattr(cuda_lib.subprocess, "Popen", FakeNvcc)
        built = cuda_lib.build_libraries()
    assert set(built) == set(cuda_lib.SOURCES) and len(commands) == len(cuda_lib.SOURCES) == 3
    assert dcn.build_libraries is cuda_lib.build_libraries

    real_run = fast_cocoeval.subprocess.run

    def recording_run(argv, **kw):
        commands.append(list(argv))
        return real_run(argv, **kw)

    monkeypatch.setattr(fast_cocoeval, "BUILD_DIR", tmp_path / "cocoeval")
    monkeypatch.setattr(fast_cocoeval, "_LIB", None)
    monkeypatch.setattr(fast_cocoeval.subprocess, "run", recording_run)
    library = fast_cocoeval.build_library()
    assert library.exists() and len(commands) == 4
    sources = [pathlib.Path(a).resolve() for argv in commands for a in argv
               if a.endswith((".cu", ".cpp", ".cc", ".c"))]
    assert len(sources) == 4, [shlex.join(c) for c in commands]
    for src in sources:
        assert src.is_relative_to(port) and src.exists(), src
    assert {s.name for s in sources} == {"dcn_fwd.cu", "dcn_bwd.cu", "nms.cu", "cocoeval.cpp"}

    spec = importlib.util.spec_from_file_location(
        "_cocoeval_oracle", os.path.join(REPO, "tests", "evaluation", "test_cocoeval_oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    case = oracle._fixture()
    stats = []
    for cls in (fast_cocoeval.FastCOCOEval, COCOEval):
        ev = cls(*case)
        ev.evaluate()
        stats.append(ev.summarize())
    np.testing.assert_array_equal(stats[0], stats[1])
    np.testing.assert_allclose(stats[0], oracle._FROZEN, atol=1e-5)
