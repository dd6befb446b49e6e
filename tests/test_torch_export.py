"""Export and int8 PTQ of the port against the JAX package on the CPU.

* K1 and the NMS as ``torch.library`` custom ops: ``torch.library.opcheck``
  on the CPU (the card's case is in ``tests/test_torch_cuda.py``).
* ``export/api.py``: a narrow ctdet DLA-34 (LEVELS 1, CHANNELS [8, 8, 16, 16, 32,
  32], HEAD_CONV 16, 4 classes, 64², batch 2) and a narrow RetinaNet R18-FPN
  (RES2 16, FPN 32, 128², batch 2) exported, each program's custom-op
  nodes counted, then loaded in a fresh process that imports the port and
  no JAX: equal to eager ``predict_fn`` within 1e-6; the ctdet program
  against JAX's ``load_exported(export_stablehlo(...))`` on the same
  weights within 1e-4 (JAX's own atol).
* ``export/quantization.py``: the int8 values and scales equal JAX's, key
  for key (ctdet DLA-34 and ResNet-18-deconv, whose transposed convs
  quantize over their second axis); ``quantization_error`` and the
  calibrated ranges against JAX's.

Weights cross from one numpy-made variables tree through
``state_dict_from_jax``; f32 and ``TEST.EXACT_MODE`` on both sides.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.export import calibrate_activations as jax_calibrate
from detectron2_centernet_tpu.export import export_stablehlo
from detectron2_centernet_tpu.export import load_exported as jax_load_exported
from detectron2_centernet_tpu.export import quantization_error as jax_quantization_error
from detectron2_centernet_tpu.export import quantize_variables as jax_quantize
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.checkpoint.from_jax import canonical_key, key_options, port_layout
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.export import (calibrate_activations, custom_op_nodes, dequantize_variables,
                                                   export_program, load_exported, quantization_error,
                                                   quantize_variables)
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.ops import dcn, nms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTDET = ["MODEL.CENTERNET.LEVELS", [1, 1, 1, 1, 1, 1], "MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
         "MODEL.CENTERNET.TASK.HM", 4, "DATASETS.TRAIN", (), "TPU.DTYPE", "float32", "TEST.EXACT_MODE", True]
RES18_DECONV = ["MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
                "MODEL.CENTERNET.HEAD_CONV", 8, "MODEL.CENTERNET.TASK.HM", 4, "DATASETS.TRAIN", (),
                "TPU.DTYPE", "float32", "TEST.EXACT_MODE", True]
RETINA = ["MODEL.WEIGHTS", "", "MODEL.DEVICE", "cpu", "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
          "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32, "MODEL.RETINANET.NUM_CONVS", 2,
          "TPU.DTYPE", "float32"]
CONFIGS = {"dla34": ("ctdet_dla_34_1x.yaml", CTDET), "res18_deconv": ("ctdet_res_18_1x.yaml", RES18_DECONV)}
SIZE, BATCH, RETINA_SIZE = 64, 2, 128
EAGER_TOL = 1e-6  # the loaded program against eager predict_fn (measured: equal)
# the ctdet program against JAX's StableHLO artifact (JAX's own atol; measured 3.0e-8 on the scores, 3.8e-6 px)
JAX_TOL = 1e-4
# quantization_error (absolute) and the calibrated ranges (relative): f32 through the narrow network in two
# frameworks (measured 9.3e-8 on an error of 3.2e-3, and 4.9e-7 over 58 convs)
QERR_TOL, RANGE_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the narrow convolutions run faster alone than
    split across a shared machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_variables(shapes, seed):
    """Every leaf random: kernels N(0, 1/fan_in), the offset convs scaled so
    offsets reach a few pixels, BN away from identity, the hm bias near
    -2.19 (scores spread across the threshold)."""
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
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _pair(name):
    """(JAX CenterNet, its variables, the port's CenterNet) on one random tree."""
    yaml, extra = CONFIGS[name]
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", yaml))
        cfg.merge_from_list(extra)
    pcfg.MODEL.DEVICE = "cpu"
    jm = jax_build_model(jcfg)
    variables = _random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE))), seed=0)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


@pytest.fixture(scope="module")
def ctdet():
    return _pair("dla34")


def _images(n, size, seed):
    return np.random.RandomState(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


# -- the custom ops --------------------------------------------------------------------------

def _dcn_args(case):
    g = torch.Generator().manual_seed(len(case))
    stride = 2 if case == "unmodulated_bf16_stride2_bias" else 1
    dilation = 2 if case == "dilation2" else 1
    dtype = torch.bfloat16 if "bf16" in case else torch.float32
    x = torch.randn(2, 8, 9, 10, generator=g).to(dtype)
    ho, wo = (9 - 1) // stride + 1, (10 - 1) // stride + 1
    offset = torch.randn(2, 18, ho, wo, generator=g) * 2
    mask = None if "unmodulated" in case else torch.rand(2, 9, ho, wo, generator=g)
    weight = torch.randn(4, 8, 3, 3, generator=g).to(dtype)
    bias = torch.randn(4, generator=g) if "bias" in case else None
    scale, shift = (torch.rand(4, generator=g) + 0.5, torch.randn(4, generator=g)) if "epilogue" in case else (None,
                                                                                                             None)
    return (x, offset, mask, weight, bias, scale, shift, "epilogue" in case, stride, dilation)


@pytest.mark.parametrize("case", ["modulated_epilogue", "unmodulated_bf16_stride2_bias", "dilation2"])
def test_dcn_custom_op_passes_opcheck(case):
    """``torch.ops.d2ct.dcn_fwd``: schema, fake (the output's shape and
    dtype), autograd registration and the AOT dispatch, on the CPU; the
    wrapper's output is the op's and the plain version's."""
    args = _dcn_args(case)
    torch.library.opcheck(torch.ops.d2ct.dcn_fwd, args)
    out = dcn.modulated_deform_conv(*args[:4], bias=args[4], post_scale=args[5], post_shift=args[6],
                                    post_relu=args[7], stride=args[8], dilation=args[9])
    want = dcn.modulated_deform_conv_plain(*args)
    assert out.dtype == args[0].dtype and out.shape == want.shape
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert dcn.modulated_deform_conv.launches == 0


def _nms_rows(seed, rows=3, cands=60):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(rows, cands, 2, generator=g) * 40
    boxes = torch.cat([xy, xy + torch.rand(rows, cands, 2, generator=g) * 20 + 1], -1)
    scores = torch.rand(rows, cands, generator=g)
    scores[:, ::7] = float("-inf")
    return boxes, scores


@pytest.mark.parametrize("counts", [None, [3, 10, 0]], ids=["k", "per_row"])
def test_nms_custom_op_passes_opcheck(counts):
    """``torch.ops.d2ct.greedy_nms`` with one pick count or one a row:
    opcheck, and ``greedy_nms`` equal to the plain loop."""
    boxes, scores = _nms_rows(1)
    k = 10 if counts is None else max(counts)
    torch.library.opcheck(torch.ops.d2ct.greedy_nms, (boxes, scores, 0.5, k, counts))
    got = nms.greedy_nms(boxes, scores, 0.5, k if counts is None else counts)
    want = nms.nms_fixed(boxes, scores, 0.5, k if counts is None else counts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert nms.greedy_nms.launches == 0


# -- export ----------------------------------------------------------------------------------

def _retinanet():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", "retinanet_R_50_FPN_1x.yaml"))
    cfg.merge_from_list(RETINA)
    model = build_model(cfg)
    with torch.no_grad():  # the init's prior-prob bias puts every score under SCORE_THRESH_TEST
        model.model.head.cls_score.bias.fill_(-1.0)
    return model


@pytest.fixture(scope="module")
def exported(ctdet, tmp_path_factory):
    """Both programs written to .pt2 files, with their inputs and eager
    outputs: {name: (path, inputs, eager outputs, custom-op nodes, the
    program)}."""
    root = tmp_path_factory.mktemp("export")
    out = {}
    for name, model, size in (("ctdet", ctdet[2], SIZE), ("retinanet", _retinanet(), RETINA_SIZE)):
        x = _nchw(_images(BATCH, size, seed=5))
        path = str(root / f"{name}.pt2")
        program = export_program(model, BATCH, (size, size), path)
        out[name] = (path, x, model.predict_fn(x), custom_op_nodes(program), program)
    return out


def test_programs_record_the_kernels_as_custom_ops(exported):
    """The ctdet program holds K1's 16 nodes, RetinaNet's one NMS node."""
    assert exported["ctdet"][3] == {"d2ct.dcn_fwd.default": 16}
    assert exported["retinanet"][3] == {"d2ct.greedy_nms.default": 1}


def test_programs_load_in_a_fresh_process_without_jax(exported, tmp_path):
    """Each .pt2 loaded by a new interpreter that imports only the port
    (``export.load_exported``): its outputs equal eager ``predict_fn``'s
    within EAGER_TOL, and no JAX module is loaded."""
    io = {name: (path, x) for name, (path, x, *_) in exported.items()}
    torch.save(io, tmp_path / "io.pt")
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from detectron2_centernet_tpu_torch.export import load_exported\n"
        f"io = torch.load({str(tmp_path / 'io.pt')!r})\n"
        "out = {}\n"
        "for name, (path, x) in io.items():\n"
        "    model = load_exported(path)\n"
        "    out[name] = {k: v.tolist() for k, v in model(x).items()}\n"
        "out['jax'] = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'detectron2_centernet_tpu'))\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got.pop("jax") == []
    for name, (_, _, eager, *_) in exported.items():
        assert set(got[name]) == set(eager) == {"boxes", "scores", "classes"}
        for k, v in eager.items():
            np.testing.assert_allclose(np.asarray(got[name][k]), v.numpy(), rtol=0, atol=EAGER_TOL)
    assert (eager["scores"] > 0).any()  # RetinaNet's program picked detections


def test_exported_model_checks_its_input_and_runs_in_ieee_f32(exported, monkeypatch):
    """``ExportedModel`` takes the exported shape only, and calls the program
    inside ``ieee_f32()``."""
    from detectron2_centernet_tpu_torch.export import api

    _, x, _, _, program = exported["ctdet"]
    model = load_exported(program)
    assert model.input_shape == (BATCH, 3, SIZE, SIZE) and model.device == torch.device("cpu")
    with pytest.raises(ValueError, match="takes"):
        model(x[:1])
    entered = []
    monkeypatch.setattr(api, "ieee_f32", lambda: entered.append(1) or torch.backends.cudnn.flags())
    model(x.numpy())
    assert entered == [1]


def test_ctdet_program_matches_the_jax_artifact(ctdet, exported):
    """JAX's StableHLO artifact of the same weights on the same images:
    every slot above SCORE_THRESH_TEST the same class, its score and box
    within JAX_TOL (the port's program runs the plain DCN on the CPU)."""
    jm, variables, pm = ctdet
    images = _images(BATCH, SIZE, seed=5)
    want = {k: np.asarray(v) for k, v in
            jax_load_exported(export_stablehlo(jm, variables, BATCH, (SIZE, SIZE)))(images).items()}
    got = {k: v.numpy() for k, v in load_exported(exported["ctdet"][4])(_nchw(images)).items()}
    for i in range(BATCH):
        keep = want["scores"][i] > pm.score_threshold
        assert keep.sum() > 10 and (got["scores"][i] > pm.score_threshold).sum() == keep.sum()
        np.testing.assert_array_equal(got["classes"][i][keep], want["classes"][i][keep])
        np.testing.assert_allclose(got["scores"][i][keep], want["scores"][i][keep], rtol=0, atol=JAX_TOL)
        np.testing.assert_allclose(got["boxes"][i][keep], want["boxes"][i][keep], rtol=0, atol=JAX_TOL)


# -- int8 PTQ --------------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_values_and_scales_equal_jax_key_for_key(name):
    """Every kernel JAX quantizes, and no other, is quantized by the port:
    its int8 values (crossed to the port's layout) and its per-channel
    scales equal JAX's exactly; dequantized, it is ``q · scale``."""
    jm, variables, pm = _pair(name)
    want = flatten_dict(jax_quantize(variables)["tree"], sep="/")
    jax_q = {p[: -len("/q")]: v for p, v in want.items() if p.endswith("/q")}
    packed = quantize_variables(pm.model)["tree"]
    options = key_options(pm.model)
    got = {canonical_key(k, **options): (k, v) for k, v in packed.items() if isinstance(v, dict)}
    assert set(got) == set(jax_q) and len(got) > 10
    shapes = {p: v.shape for p, v in flatten_dict(variables, sep="/").items()}
    for path, (key, leaf) in got.items():
        q = port_layout(key, jax_q[path].astype(np.float32), shapes)
        np.testing.assert_array_equal(leaf["q"].numpy(), q.astype(np.int8))
        np.testing.assert_array_equal(leaf["scale"].numpy(), want[path + "/scale"])
    deq = dequantize_variables({"tree": packed})
    pm.model.load_state_dict(deq)
    for key, leaf in packed.items():
        if isinstance(leaf, dict):
            shape = [1] * leaf["q"].dim()
            shape[leaf["axis"]] = -1
            torch.testing.assert_close(deq[key], leaf["q"].float() * leaf["scale"].view(shape), rtol=0, atol=0)
    if name == "res18_deconv":  # the transposed convs' channels are their second axis
        assert {leaf["axis"] for k, leaf in packed.items() if isinstance(leaf, dict) and "deconv" in k} == {1}


def test_quantization_error_matches_jax(ctdet):
    """The raw maps under int8 weights against f32 on the same batch: the
    port's error equals JAX's within QERR_TOL and holds JAX's bound
    (``tests/test_export.py``: 0.08); the weights come back."""
    jm, variables, pm = ctdet
    images = _images(1, SIZE, seed=7)
    # JAX's function, its two forwards through one jitted apply (op by op they take ~10 s)
    apply = jax.jit(jm.module.apply, static_argnames="train")
    jitted = types.SimpleNamespace(normalize=jm.normalize, module=types.SimpleNamespace(apply=apply))
    want = jax_quantization_error(jitted, variables, images)["output_max_rel_err"]
    before = {k: v.clone() for k, v in pm.model.state_dict().items()}
    got = quantization_error(pm, _nchw(images))["output_max_rel_err"]
    assert abs(got - want) <= QERR_TOL * max(want, 1.0), (got, want)
    assert 0 < got < 0.08
    for k, v in pm.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_calibrated_ranges_match_jax(ctdet):
    """Each conv's output |max| on a calibration batch equals JAX's range of
    the same flax module within RANGE_TOL of it."""
    jm, variables, pm = ctdet
    images = _images(2, SIZE, seed=8)
    want = jax_calibrate(jm, variables, images)
    got = calibrate_activations(pm, _nchw(images))
    options = key_options(pm.model)
    pairs = 0
    for name, module in pm.model.named_modules():
        if not isinstance(module, torch.nn.Conv2d):
            continue
        path = canonical_key(name + ".weight", **options)
        flax_module = path[len("params/"):-len("/kernel")] if path and path.endswith("/kernel") else None
        if flax_module in want:
            pairs += 1
            assert abs(got[name] - want[flax_module]) <= RANGE_TOL * want[flax_module], name
    assert pairs >= 20 and got[""] > 0
