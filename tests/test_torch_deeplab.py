"""The port's DeepLab V3 and V3+ against the JAX package on the CPU, in f32,
at a small size (ResNet-50 with RES2 32, 8 channels a group, a DeepLab stem
of 16, BatchNorm, res5 at dilation 2 with the multi-grid (1, 2, 4); ASPP of
16 at dilations (6, 12, 18); 5 classes; 64² inputs): the trunk (the
DeepLab stem, ``RES4_DILATION``, the multi-grid at dilations up to 16),
``ASPP``, both heads on crossed weights, the hard-pixel-mining loss with
every gradient and one SGD step, ``predict_fn``, the two Cityscapes
YAMLs, ``CityscapesSemSegEvaluator`` and the head keys neither package
reads (ROADMAP C26).

One random variables tree, made with numpy from a seed, goes to both: as it
is to the JAX model, through ``state_dict_from_jax`` to the port.
Tolerances: 1e-5 of the output's scale for the trunk, the heads and the
logits, 1e-5 relative for the loss, 1e-4 of each gradient's own max for the
gradients and of its scale for each SGD move, 1e-9 for the evaluator.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.evaluation.cityscapes_evaluation import CityscapesSemSegEvaluator as JaxCityscapesSemSeg
from detectron2_centernet_tpu.models import layers as jax_layers
from detectron2_centernet_tpu.models.backbones import resnet as jax_resnet
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.meta_arch import semantic_seg as jax_semseg
from detectron2_centernet_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_centernet_tpu_torch.evaluation import CityscapesSemSegEvaluator
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.backbones import resnet
from detectron2_centernet_tpu_torch.models.layers import ASPP
from detectron2_centernet_tpu_torch.models.meta_arch import semantic_seg
from detectron2_centernet_tpu_torch.solver import build_optimizer
from detectron2_centernet_tpu_torch.tools import train_net

from test_torch_rcnn import SIZE, _close, _images, _nchw, _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "projects", "DeepLab", "configs", "Cityscapes-SemanticSegmentation")
TRUNK = ["MODEL.BACKBONE.NAME", "build_resnet_deeplab_backbone", "MODEL.BACKBONE.FREEZE_AT", 0,
         "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 32, "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
         "MODEL.RESNETS.STEM_OUT_CHANNELS", 16, "MODEL.RESNETS.NORM", "BN", "MODEL.RESNETS.STEM_TYPE", "deeplab",
         "MODEL.RESNETS.RES5_DILATION", 2, "MODEL.RESNETS.RES5_MULTI_GRID", [1, 2, 4],
         "MODEL.RESNETS.STRIDE_IN_1X1", False]
V3_PLUS = ["MODEL.META_ARCHITECTURE", "SemanticSegmentor", "MODEL.RESNETS.OUT_FEATURES", ["res2", "res5"],
           "MODEL.SEM_SEG_HEAD.NAME", "DeepLabV3PlusHead", "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["res2", "res5"],
           "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16, "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 5,
           "MODEL.SEM_SEG_HEAD.COMMON_STRIDE", 4, "MODEL.SEM_SEG_HEAD.LOSS_TYPE", "hard_pixel_mining",
           "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "TPU.DTYPE", "float32",
           "TEST.EXACT_MODE", True, "INPUT.COLOR_JITTER", False, "DATASETS.TRAIN", ()]
V3 = ["MODEL.RESNETS.OUT_FEATURES", ["res5"], "MODEL.SEM_SEG_HEAD.NAME", "DeepLabV3Head",
      "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["res5"], "MODEL.SEM_SEG_HEAD.COMMON_STRIDE", 16]
NARROW = ["MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
          "MODEL.RESNETS.WIDTH_PER_GROUP", 8, "MODEL.RESNETS.STEM_OUT_CHANNELS", 16, "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
          "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "TPU.DTYPE", "float32",
          "TEST.EXACT_MODE", True]


def _cfgs(extra=(), yaml=None):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    if yaml:
        jcfg.merge_from_file(os.path.join(CONFIGS, yaml))
        pcfg.merge_from_file(os.path.join(CONFIGS, yaml))
    base = [] if yaml else TRUNK + V3_PLUS
    jcfg.merge_from_list(base + list(extra))
    pcfg.merge_from_list(base + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _pair(extra=(), seed=0, yaml=None):
    """(JAX SemanticSegmentor, its random variables, the port's with them)."""
    jcfg, pcfg = _cfgs(extra, yaml)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


@pytest.fixture(scope="module")
def v3_plus():
    return _pair()


def _labels(seed, n=2, classes=5, ignore_share=0.2):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, classes, (n, SIZE, SIZE)).astype(np.int32)
    lab[rng.rand(n, SIZE, SIZE) < ignore_share] = 255
    return lab


# -- the trunk --------------------------------------------------------------------------------------------


@pytest.mark.parametrize("extra, res5_dilations", [
    ([], (2, 4, 8)),  # output stride 16: res5 at 2 · (1, 2, 4)
    (["MODEL.RESNETS.RES4_DILATION", 2, "MODEL.RESNETS.RES5_DILATION", 4], (4, 8, 16)),  # output stride 8
    (["MODEL.RESNETS.STEM_TYPE", "basic", "MODEL.RESNETS.RES5_MULTI_GRID", [1, 1, 1],
      "MODEL.RESNETS.STRIDE_IN_1X1", True], (2, 2, 2)),  # DC5's trunk through build_resnet_deeplab_backbone
], ids=["os16_mg124", "os8_res4_dilated", "basic_stem_dc5"])
def test_deeplab_trunk_matches_jax(extra, res5_dilations):
    """The trunk alone (BatchNorm in eval mode) on crossed weights:
    res2-res5 within 1e-5 of their scale; the DeepLab stem's three convs
    (16/2, 16/2, 16 channels) and each res5 block's 3x3 at its dilation,
    padded by it, as JAX's; a dilated stage's first block does not stride."""
    jcfg, pcfg = _cfgs(["MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"]] + extra)
    jtrunk = jax_resnet.build_resnet_deeplab_backbone(jcfg)
    x = _images(2, seed=3) / 64.0 - 2.0
    shapes = jax.eval_shape(lambda: jtrunk.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, 4)
    want = jax.jit(lambda v, a: jtrunk.apply(v, a))(variables, jnp.asarray(x))
    trunk = resnet.build_resnet_deeplab_backbone(pcfg)
    state = state_dict_from_jax({k: {"backbone": v} for k, v in variables.items()})
    trunk.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    trunk.eval()
    with torch.no_grad():
        got = trunk(_nchw(x))
    for name in ("res2", "res3", "res4", "res5"):
        w = np.asarray(want[name]).transpose(0, 3, 1, 2)
        assert tuple(got[name].shape) == w.shape, name
        _close(got[name].numpy(), w, 1e-5, name)
    deeplab_stem = "MODEL.RESNETS.STEM_TYPE" not in extra
    assert isinstance(trunk.stem, resnet.DeepLabStem) == deeplab_stem
    if deeplab_stem:
        assert [trunk.stem.get_submodule(c).weight.shape[0] for c in ("conv1", "conv2", "conv3")] == [8, 8, 16]
    assert tuple(b.conv2.dilation[0] for b in trunk.res5) == res5_dilations
    assert all(b.conv2.padding[0] == b.conv2.dilation[0] for b in trunk.res5)
    assert trunk.res5[0].conv2.stride[0] == 1 and got["res5"].shape[-1] == got["res4"].shape[-1]


def test_deeplab_backbone_needs_a_deeplab_option_as_jax():
    """``build_resnet_deeplab_backbone`` on a plain trunk raises in both
    packages (JAX: its assert)."""
    extra = ["MODEL.RESNETS.STEM_TYPE", "basic", "MODEL.RESNETS.RES5_DILATION", 1]
    jcfg, pcfg = _cfgs(extra)
    with pytest.raises(AssertionError):
        jax_resnet.build_resnet_deeplab_backbone(jcfg)
    with pytest.raises(ValueError, match="STEM_TYPE deeplab"):
        resnet.build_resnet_deeplab_backbone(pcfg)


# -- ASPP and the heads ------------------------------------------------------------------------------------


def test_aspp_on_crossed_weights_matches_jax():
    """ASPP alone on a random (2, 24, 9, 11) map: the 1x1, the three
    dilated 3x3s (6, 12, 18: most of their taps fall in the padding), the
    pooling branch and the projection, within 1e-5 of the output's scale;
    the reference's keys."""
    x = np.random.RandomState(5).randn(2, 9, 11, 24).astype(np.float32)
    jaspp = jax_layers.ASPP(16, dilations=(6, 12, 18))
    variables = _random_variables(jax.eval_shape(lambda: jaspp.init(jax.random.PRNGKey(0), jnp.asarray(x))), 6)
    want = np.asarray(jaspp.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    aspp = ASPP(24, 16, (6, 12, 18))
    state = state_dict_from_jax({"params": {"head": {"aspp": variables["params"]}}})
    aspp.load_state_dict({k.removeprefix("sem_seg_head.aspp."): v for k, v in state.items()})
    assert sorted(aspp.state_dict()) == sorted(k.removeprefix("sem_seg_head.aspp.") for k in state)
    with torch.no_grad():
        got = aspp(_nchw(x)).numpy()
    _close(got, want, 1e-5, "aspp")


@pytest.mark.parametrize("name", ["DeepLabV3Head", "DeepLabV3PlusHead"])
def test_deeplab_heads_on_crossed_weights_match_jax(name):
    """Each head alone on random res2 (2, 32, 16, 16) and res5 (2, 64, 4,
    4) maps: V3 upsamples its res5 logits ×16, V3+ resizes ASPP's output to
    res2's size, fuses it with the 48-channel projection, upsamples ×4:
    (2, 5, 64, 64) within 1e-5 of their scale."""
    rng = np.random.RandomState(7)
    feats = {"res2": rng.randn(2, 16, 16, 32).astype(np.float32), "res5": rng.randn(2, 4, 4, 64).astype(np.float32)}
    plus = name == "DeepLabV3PlusHead"
    in_features = ("res2", "res5") if plus else ("res5",)
    cls = getattr(jax_semseg, name)
    jhead = cls(in_features=in_features, strides=(4, 16) if plus else (16,), num_classes=5, convs_dim=16,
                common_stride=4 if plus else 16)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = _random_variables(jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jfeats)), 8)
    want = np.asarray(jhead.apply(variables, jfeats)).transpose(0, 3, 1, 2)
    if plus:
        head = semantic_seg.DeepLabV3PlusHead(in_features, 32, 64, 5, 16, 4)
    else:
        head = semantic_seg.DeepLabV3Head(in_features, 64, 5, 16, 16)
    state = state_dict_from_jax({"params": {"head": variables["params"]}})
    head.load_state_dict({k.removeprefix("sem_seg_head."): v for k, v in state.items()})
    with torch.no_grad():
        got = head({k: _nchw(v) for k, v in feats.items()}).numpy()
    assert got.shape == want.shape == (2, 5, 64, 64)
    _close(got, want, 1e-5, name)


def test_head_keys_neither_package_reads():
    """ROADMAP C26: JAX's DeepLab heads read no ``SEM_SEG_HEAD.NORM``,
    ``ASPP_CHANNELS``, ``ASPP_DROPOUT``, ``PROJECT_FEATURES`` or
    ``PROJECT_CHANNELS``; its ASPP and decoder convs have biases and no
    norm, ASPP's width is ``CONVS_DIM`` and the projection 48. The port
    follows: with those keys set otherwise, both packages build the same
    leaves, names and shapes, as without them."""
    odd = ["MODEL.SEM_SEG_HEAD.NORM", "SyncBN", "MODEL.SEM_SEG_HEAD.ASPP_CHANNELS", 7,
           "MODEL.SEM_SEG_HEAD.ASPP_DROPOUT", 0.5, "MODEL.SEM_SEG_HEAD.PROJECT_FEATURES", ["res2"],
           "MODEL.SEM_SEG_HEAD.PROJECT_CHANNELS", [7]]
    shapes = {}
    for extra in ([], odd):
        jcfg, pcfg = _cfgs(extra)
        jm = jax_build_model(jcfg)
        tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
        head = {"/".join(str(p.key) for p in path): leaf.shape
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0] if path[1].key == "head"}
        port = {k: tuple(v.shape) for k, v in build_model(pcfg).model.sem_seg_head.state_dict().items()}
        shapes[len(extra)] = (head, port)
    assert shapes[0] == shapes[len(odd)]
    head, port = shapes[0]
    assert head["params/head/aspp/conv1x1/bias"] == (16,) and head["params/head/low_level_proj/kernel"] == (1, 1, 32, 48)
    assert port["aspp.convs.0.bias"] == (16,) and port["low_level_proj.weight"] == (48, 32, 1, 1)
    assert not any("norm" in k for k in port)


# -- the whole model ---------------------------------------------------------------------------------------


def test_hard_mining_loss_every_gradient_and_one_sgd_step_match_jax_in_f64():
    """V3+ with ``LOSS_TYPE hard_pixel_mining`` (the top 20% of the
    per-pixel losses) in training mode (BatchNorm on the batch's
    statistics), both sides in f64 but for the predictor, the upsample and
    the loss, which both keep in f32: in f32 the train-mode BatchNorms of
    this random trunk magnify rounding (a few gradients of res3-res4 came
    1-17% of their scale apart; ``tools/grad_conditioning.py`` measures the
    same for the ResNet CenterNets). ``loss_sem_seg`` within 1e-5 relative;
    every parameter's gradient within 1e-5 of its own max |value|; the
    BatchNorm statistics the step folds in within 1e-6 of their scale; one
    SGD step of the optimizer (LR 0.01, momentum 0.9, weight decay 1e-4,
    none on norms) from those gradients: every parameter's move within 1e-4
    of its scale of JAX's (and two f32 steps of the parameter)."""
    extra = ["SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 0]
    jm, variables, pm = _pair(extra, seed=1)
    jcfg, pcfg = _cfgs(extra)
    batch = {"image": _images(2, 9), "sem_seg": _labels(10)}
    with jax.enable_x64(True):
        jm64 = copy.copy(jm)
        jm64.module = jm.module.clone(backbone=jm.module.backbone.clone(dtype=jnp.float64),
                                      head=jm.module.head.clone(dtype=jnp.float64))
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (_, (jloss, jstats)), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jm64.loss_fn(p, v64["batch_stats"], jbatch), has_aux=True))(v64["params"])
        jloss = {k: float(v) for k, v in jloss.items()}
        jgrads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jgrads)
        new_stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, jstats)})
    model = copy.deepcopy(pm.model).double()
    model.sem_seg_head.predictor.float()
    model.backbone.register_forward_pre_hook(lambda m, args: (args[0].double(),) + args[1:])
    port = copy.copy(pm)
    port.model = model.train()
    total, losses = port.loss_fn({"image": _nchw(batch["image"]), "sem_seg": torch.from_numpy(batch["sem_seg"])})
    total.backward()
    assert pm.loss_top_k == 0.2 and set(losses) == set(jloss) == {"loss_sem_seg"}
    np.testing.assert_allclose(losses["loss_sem_seg"].item(), jloss["loss_sem_seg"], rtol=1e-5)
    want = state_dict_from_jax({"params": jgrads})
    grads = {k: p.grad.float() for k, p in model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), k
    assert grads["backbone.stem.conv1.weight"].abs().max() > 0 and grads["sem_seg_head.aspp.convs.4.1.weight"].any()
    state = model.state_dict()
    for k, w in new_stats.items():
        if not k.endswith("num_batches_tracked"):
            _close(state[k].float().numpy(), w.numpy(), 1e-6, k)

    opt, _ = build_optimizer(pcfg, pm.model)
    for k, p in pm.model.named_parameters():
        p.grad = grads[k].clone()
    params = variables["params"]
    tx = jax_build_optimizer(jcfg, params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jax_moves = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, updates)})
    before = {k: p.detach().clone() for k, p in pm.model.named_parameters()}
    opt.step()
    for k, p in pm.model.named_parameters():
        move, w = (p.detach() - before[k]).numpy(), jax_moves[k].numpy()
        assert np.abs(move - w).max() <= 1e-4 * np.abs(w).max() + 2 * np.spacing(np.float32(before[k].abs().max())), k


@pytest.mark.parametrize("head", ["v3_plus", "v3"])
def test_predict_fn_logits_match_jax(v3_plus, head):
    """``predict_fn`` on two 64² images: (2, 5, 64, 64) f32 logits within
    1e-5 of their scale of JAX's; V3 upsamples its stride-16 res5 ×16."""
    jm, variables, pm = v3_plus if head == "v3_plus" else _pair(V3, seed=2)
    x = _images(2, seed=11)
    want = np.asarray(jax.jit(jm.predict_fn)(variables, jnp.asarray(x))["sem_seg"]).transpose(0, 3, 1, 2)
    got = pm.predict_fn(_nchw(x))["sem_seg"]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 5, SIZE, SIZE)
    _close(got.numpy(), want, 1e-5, "sem_seg logits")
    assert type(pm.model.sem_seg_head).__name__ == ("DeepLabV3PlusHead" if head == "v3_plus" else "DeepLabV3Head")


@pytest.mark.parametrize("yaml", ["deeplab_v3_plus_R_50_os16_poly_90k_bs16.yaml",
                                  "deeplab_v3_R_103_os16_mg124_poly_90k_bs16.yaml"])
def test_cityscapes_yamls_build_and_match_jax(yaml):
    """Each Cityscapes YAML, narrowed (ResNet-50 for R-103's 101, RES2 32,
    stem 16, head 16), builds the same network in both packages (every JAX
    leaf crosses, strictly) and ``predict_fn`` agrees within 1e-5 of the
    logits' scale: 19 classes; the R-103 one's DeepLab stem, SyncBN trunk,
    multi-grid res5 and V3 head at ``COMMON_STRIDE`` 16; V3+'s at 4 on res2
    and res5. The R-103 YAML sets no ``INPUT.TRAIN_SIZE`` / ``TEST_SIZE``,
    and both read the defaults, 512²."""
    jcfg, pcfg = _cfgs(NARROW, yaml)
    assert tuple(get_cfg().INPUT.TEST_SIZE) == (512, 512)
    jm, variables, pm = _pair(NARROW, seed=12, yaml=yaml)
    s = pcfg.MODEL.SEM_SEG_HEAD
    assert s.NUM_CLASSES == 19 and s.LOSS_TYPE == "hard_pixel_mining" and pcfg.MODEL.RESNETS.STEM_TYPE == "deeplab"
    assert type(pm.model.sem_seg_head).__name__ == s.NAME
    x = _images(1, seed=13)
    want = np.asarray(jax.jit(jm.predict_fn)(variables, jnp.asarray(x))["sem_seg"]).transpose(0, 3, 1, 2)
    got = pm.predict_fn(_nchw(x))["sem_seg"].numpy()
    assert got.shape == want.shape == (1, 19, SIZE, SIZE)
    _close(got, want, 1e-5, yaml)


# -- the evaluator --------------------------------------------------------------------------------------------


def _cityscapes_records(name, rng, n=3, size=(24, 40)):
    recs = []
    for i in range(n):
        gt = rng.randint(0, 18, size)  # no class 18
        gt[rng.rand(*size) < 0.1] = 255
        recs.append({"image_id": f"frankfurt_{i:06d}_000019_leftImg8bit.png", "height": size[0], "width": size[1],
                     "sem_seg": gt})
    if name not in DatasetCatalog:
        DatasetCatalog.register(name, lambda: recs)
        MetadataCatalog.get(name).set(evaluator_type="cityscapes_sem_seg", ignore_label=255,
                                      stuff_classes=[f"class{i}" for i in range(19)])
    return DatasetCatalog.get(name)


def _same_results(got, want):
    assert list(got) == list(want) and len(got) == 20
    for k in want:
        assert (np.isnan(got[k]) and np.isnan(want[k])) or abs(got[k] - want[k]) <= 1e-9, k


def test_cityscapes_sem_seg_evaluator_equals_jax():
    """Three images of 19 classes (int64 labels), a tenth of the ground
    truth ignored, class 17 in the ground truth only and 18 nowhere:
    ``IoU`` and every ``IoU-<class>`` equal JAX's within 1e-9 (NaN where
    JAX's is), the port reading the ground truth from the dataset's records
    (its loop, as JAX's, passes no ``sem_seg``) and from the inputs;
    ``train_net`` builds it for ``evaluator_type`` cityscapes_sem_seg.
    ROADMAP C28: JAX's loop hands the evaluator no ``sem_seg`` (it raises
    KeyError), and with the uint8 labels of a trainId PNG its index wraps
    from class 14 on, where the port's gives the int64 labels' numbers."""
    from detectron2_centernet_tpu.data import DatasetCatalog as JaxDatasetCatalog
    from detectron2_centernet_tpu.data import MetadataCatalog as JaxMetadataCatalog

    rng = np.random.RandomState(14)
    name = "test_torch_deeplab_cityscapes_sem_seg"
    recs = _cityscapes_records(name, rng)
    if name not in JaxDatasetCatalog:
        JaxDatasetCatalog.register(name, lambda: recs)
        JaxMetadataCatalog.get(name).set(stuff_classes=[f"class{i}" for i in range(19)])
    preds = [rng.randint(0, 17, r["sem_seg"].shape) for r in recs]

    def jax_results(gts):
        jev = JaxCityscapesSemSeg(name)
        jev.reset()
        jev.process([{"sem_seg": g} for g in gts], [{"sem_seg": p} for p in preds])
        return jev.evaluate()["sem_seg"]

    want = jax_results([r["sem_seg"] for r in recs])
    ev = train_net.Trainer.build_evaluator(get_cfg(), name)
    assert isinstance(ev, CityscapesSemSegEvaluator)
    for inputs in ([{"image_id": r["image_id"], "height": 24, "width": 40} for r in recs],
                   [{"sem_seg": r["sem_seg"]} for r in recs], [{"sem_seg": r["sem_seg"].astype(np.uint8)} for r in recs]):
        ev.reset()
        ev.process(inputs, [{"sem_seg": p} for p in preds])
        got = ev.evaluate()["sem_seg"]
        _same_results(got, want)
    assert want["IoU-class17"] == 0 and np.isnan(want["IoU-class18"]) and want["IoU-class16"] > 0
    wrapped = jax_results([r["sem_seg"].astype(np.uint8) for r in recs])
    assert wrapped["IoU-class16"] != want["IoU-class16"] and wrapped["IoU"] != want["IoU"]
    jev = JaxCityscapesSemSeg(name)
    with pytest.raises(KeyError):  # what JAX's evaluation loop hands it (evaluator.py:185-192)
        jev.process([{"image_id": recs[0]["image_id"], "height": 24, "width": 40}], [{"sem_seg": preds[0]}])
