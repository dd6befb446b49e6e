"""The port's Cascade R-CNN (``CascadeROIHeads``, with its mask head) against
the JAX package on the CPU, in f32, at ``test_torch_rcnn``'s small size
(ResNet-18 with RES2 16 and a stem of 8, FPN 32, FC_DIM 64, 5 classes, 64
rois per image, 64² inputs) with the mask head of ``test_torch_mask``
(convs of 32, 16² rasters): ``scale_gradient``, ``clip_boxes`` and
``cascade_relabel`` against JAX's on quantized boxes (IoU ties and IoUs on
the stage thresholds), the weights across both ways, the loss terms of the
three stages and every gradient on JAX's draws (the later stages' relabelled
slots equal JAX's, slot for slot), ``predict_fn`` with masks,
``DefaultPredictor``, and a ``DefaultTrainer`` run with its evaluation.

JAX runs with ``TPU.DTYPE=float32`` and ``TEST.EXACT_MODE``; the port with
``MODEL.DEVICE=cpu``; the variables are ``test_torch_rcnn``'s random tree.
"""

import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from detectron2_centernet_tpu.engine import DefaultPredictor as JaxPredictor
from detectron2_centernet_tpu.models.meta_arch import rcnn as jax_rcnn
from detectron2_centernet_tpu_torch.checkpoint import canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import warp_image
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.engine import DefaultPredictor, DefaultTrainer
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.meta_arch import rcnn

from test_torch_mask import MASK, _mask_batch
from test_torch_rcnn import SIZE, _anchor_count, _cfgs, _images, _jax_draws, _nchw, _pair, _port_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASCADE = ["MODEL.ROI_HEADS.NAME", "CascadeROIHeads", "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", True]
LOSSES = {"loss_rpn_cls", "loss_rpn_loc", "loss_mask"} | {f"{k}_stage{t}" for k in ("loss_cls", "loss_box_reg")
                                                          for t in range(3)}


@pytest.fixture(scope="module")
def pair():
    return _pair(CASCADE + MASK)


# -- the pieces --------------------------------------------------------------------------------------


def test_scale_gradient_is_the_identity_and_scales_the_gradient_as_jax():
    """Forward the identity; backward ``g · scale``, as JAX's custom VJP."""
    rng = np.random.RandomState(0)
    x, g = rng.randn(5, 3).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    want_y, vjp = jax.vjp(lambda v: jax_rcnn._scale_gradient(v, 1 / 3), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    y = rcnn.scale_gradient(t, 1 / 3)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


THRESHOLDS = (0.5, 0.6, 0.7)


def _quantized_case(seed, n=2, m=6, s=80):
    """Boxes on a 4-px grid (so IoUs tie), a duplicated gt (argmax ties
    between two gt), an invalid gt slot, boxes reaching out of the 64²
    image (for the clip), and three boxes whose best IoU is exactly 0.5,
    0.6 and 0.7 (two gt kept apart from the random ones in x < 16)."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 8, (n, m, 2)) * 4 + np.array([16, 0])
    gt = np.concatenate([xy, xy + rng.randint(2, 8, (n, m, 2)) * 4], -1).astype(np.float32)
    gt[:, 1] = gt[:, 0]
    gt[:, 2], gt[:, 3] = [0, 0, 10, 6], [0, 20, 10, 27]
    valid = np.ones((n, m), bool)
    valid[1, 4] = False
    pick = rng.randint(0, m, (n, s))
    base = gt[np.arange(n)[:, None], pick]
    boxes = (base + rng.randint(-2, 3, (n, s, 4)) * 4).astype(np.float32)
    boxes[:, :8] = gt[:, :1]  # IoU exactly 1 with gt 0 and its duplicate, gt 1: a tie
    boxes[:, 8:12, 2:] += 40  # out of the image
    boxes[:, 12:15] = [[0, 0, 10, 12], [0, 0, 10, 10], [0, 20, 10, 30]]  # 60/120, 60/100, 70/100
    classes = rng.randint(0, 5, (n, m)).astype(np.int32)
    weights = (rng.uniform(size=(n, s)) > 0.1).astype(np.float32)
    return boxes, gt, classes, valid, weights


@pytest.mark.parametrize("iou", THRESHOLDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_cascade_relabel_on_quantized_boxes_equals_jax(seed, iou):
    """``clip_boxes`` equals JAX's ``_clip_boxes``; then ``cascade_relabel``
    on the clipped boxes equals JAX's ``_cascade_relabel`` slot for slot
    (boxes, classes, weights, targets, matched index, positive): the first
    gt on argmax ties, an invalid gt never matched while a valid one
    overlaps, IoU ≥ the threshold foreground, a best IoU exactly on it
    included."""
    boxes, gt, classes, valid, weights = _quantized_case(seed)
    clipped = jax_rcnn._clip_boxes(jnp.asarray(boxes), (SIZE, SIZE))
    got_clip = rcnn.clip_boxes(torch.from_numpy(boxes), (SIZE, SIZE))
    np.testing.assert_array_equal(got_clip.numpy(), np.asarray(clipped))
    want = jax_rcnn.GeneralizedRCNN._cascade_relabel(SimpleNamespace(num_classes=5), clipped, jnp.asarray(gt),
                                                     jnp.asarray(classes), jnp.asarray(valid),
                                                     jnp.asarray(weights).reshape(-1), iou)
    got = rcnn.cascade_relabel(got_clip, torch.from_numpy(gt), torch.from_numpy(classes), torch.from_numpy(valid),
                               torch.from_numpy(weights), iou, 5)
    for key in ("boxes", "classes", "weights", "target_boxes", "matched_idx", "is_pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert (got["matched_idx"].view(2, -1)[:, :8] == 0).all()  # ties between gt 0 and its duplicate 1: gt 0
    on = 12 + THRESHOLDS.index(iou)  # the box whose best IoU is the threshold itself
    best = rcnn.pairwise_iou_xyxy(torch.from_numpy(gt), got_clip).amax(1)
    assert (best[:, on] == torch.tensor(iou, dtype=torch.float32)).all()
    assert got["is_pos"].view(2, -1)[:, on].all() and not got["is_pos"].all()


# -- weights ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], MASK], ids=["boxes", "masks"])
def test_state_dict_from_jax_covers_every_leaf_once_both_ways(extra):
    """Every JAX leaf of the Cascade tree (``box_head_stage{t}``,
    ``box_predictor_stage{t}``, the mask head) maps to one port key of its
    shape (``roi_heads.box_head.{t}``, ``roi_heads.box_predictor.{t}``) and
    back; the port has no key beyond them; each stage's ``fc1`` crosses
    permuted from (H, W, C) to (C, H, W) rows."""
    jm, variables, pm = _pair(CASCADE + extra)
    sd = state_dict_from_jax(variables)
    own = {k for k in pm.model.state_dict() if not k.endswith("num_batches_tracked")}
    leaves = {"/".join(p) for p in flatten_dict(variables)}
    assert sorted(canonical_key(k) for k in own) == sorted(leaves)
    assert {torch_key(p) for p in leaves} == own
    for key, t in pm.model.state_dict().items():
        assert t.shape == sd[key].shape, key
    assert canonical_key("roi_heads.box_head.2.fc1.weight") == "params/box_head_stage2/fc1/kernel"
    assert torch_key("params/box_predictor_stage1/bbox_pred/bias") == "roi_heads.box_predictor.1.bbox_pred.bias"
    side = pm.pooler_resolution
    for t in range(3):
        kernel = np.asarray(variables["params"][f"box_head_stage{t}"]["fc1"]["kernel"])  # (P·P·32, 64)
        want = kernel.reshape(side, side, 32, -1).transpose(2, 0, 1, 3).reshape(kernel.shape).T
        np.testing.assert_array_equal(sd[f"roi_heads.box_head.{t}.fc1.weight"].numpy(), want)
    assert pm.model.roi_heads.box_predictor[1].bbox_pred.out_features == 4  # class-agnostic


# -- the whole model ------------------------------------------------------------------------------


def _recording_relabels(monkeypatch):
    """Record the relabelled stages of the port (its flat dicts) and of JAX
    (traced: ``loss_fn`` hands them out as part of its aux output)."""
    got, want = [], []
    port_fn, jax_fn = rcnn.cascade_relabel, jax_rcnn.GeneralizedRCNN._cascade_relabel
    monkeypatch.setattr(rcnn, "cascade_relabel", lambda *a: got.append(port_fn(*a)) or got[-1])
    monkeypatch.setattr(jax_rcnn.GeneralizedRCNN, "_cascade_relabel",
                        lambda self, *a: want.append(jax_fn(self, *a)) or want[-1])
    return got, want


def test_loss_relabelled_slots_and_every_gradient_match_jax(pair, monkeypatch):
    """The RPN losses, the three stages' ``loss_cls_stage{t}`` and
    ``loss_box_reg_stage{t}`` and ``loss_mask`` on JAX's draws within 1e-5
    relative; stages 1 and 2's relabelled slots equal JAX's (classes,
    weights, matched gt, positive; boxes and targets within 1e-2 px,
    ``test_torch_rcnn``'s box tolerance: the previous stage's deltas, ~1e-6
    apart, decoded through exp, moved boxes by up to 1.1e-3 px); every
    parameter's gradient within 1e-4 of its own max |value|, the trunk's
    through the three stages' pooled features at 1/3 each (with the scale
    left out, the FPN's gradient moves far beyond that)."""
    jm, variables, pm = pair
    batch, key = _mask_batch(1), jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    got_stages, traced = _recording_relabels(monkeypatch)

    def jax_loss(params):
        traced.clear()
        total, (losses, _) = jm.loss_fn(params, stats, jbatch)
        return total, (losses, list(traced))

    (_, (jloss, want_stages)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
    draws = _jax_draws(key, 2, _anchor_count(pm), max(100 + 6, 64))

    def port_step(scale_gradient=rcnn.scale_gradient):
        pb = _port_batch(batch, draws)
        pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
        for p in pm.model.parameters():
            p.grad = torch.zeros_like(p)
        pm.model.train()
        try:
            with monkeypatch.context() as m:
                m.setattr(rcnn, "scale_gradient", scale_gradient)
                total, losses = pm.loss_fn(pb)
                total.backward()
        finally:
            pm.model.eval()
        return losses, {k: p.grad.clone() for k, p in pm.model.named_parameters()}

    losses, grads = port_step()
    assert set(losses) == set(jloss) == LOSSES
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    assert len(got_stages) == len(want_stages) == 2
    for t, (g, w) in enumerate(zip(got_stages, want_stages), 1):
        for k in ("classes", "weights", "matched_idx", "is_pos"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=f"stage {t} {k}")
        for k in ("boxes", "target_boxes"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0, atol=1e-2, err_msg=f"stage {t} {k}")
        assert 0 < g["is_pos"].sum() < g["weights"].sum()
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    for t in range(3):
        assert grads[f"roi_heads.box_head.{t}.fc1.weight"].abs().max() > 0
    _, unscaled = port_step(lambda x, scale: x)
    lateral = "backbone.fpn_output2.weight"
    w = want[lateral].numpy()
    assert np.abs(unscaled[lateral].numpy() - w).max() > 1e-2 * np.abs(w).max()


def test_predict_fn_with_masks_matches_jax(pair):
    """Two 64² images through every stage (the softmaxes averaged, the last
    boxes decoded by zero deltas): the K = 100 slots' validity and classes
    equal JAX's, scores within 1e-4, boxes within 1e-2 px (``test_torch_rcnn``'s
    tolerances), masks within 2e-3 (``test_torch_mask``'s); the scores
    unsaturated."""
    jm, variables, pm = pair
    x = _images(2, seed=8)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    assert got["boxes"].shape == (2, 100, 4) and got["masks"].shape == (2, 100, 28, 28)
    scores = np.asarray(want["scores"])
    assert ((scores > 0.05).sum(1) >= 20).all() and ((scores > 0.05) & (scores < 0.9)).any()
    np.testing.assert_array_equal(got["scores"].numpy() > 0.05, scores > 0.05)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=2e-3)


def test_default_predictor_with_masks_matches_jax(pair, monkeypatch):
    """One BGR uint8 image of 50×70 through both DefaultPredictors (the JAX
    one fed the port's warp): the same detections (2 here: the random
    model's proposals are mostly the clipped image), classes, scores within
    1e-4, boxes within 1e-2 px, and the pasted masks equal but for pixels
    on a box edge the two boxes' 1e-2 px put on either side (under 0.1%)."""
    jm, variables, pm = pair
    jcfg, pcfg = _cfgs(CASCADE + MASK)
    port = DefaultPredictor(pcfg)
    port.model.model.load_state_dict(state_dict_from_jax(variables))
    monkeypatch.setattr(type(jm), "init", lambda self, rng, size: variables)
    ref = JaxPredictor(jcfg)
    ref._warp_image = lambda img, m, size: warp_image(img, m, size).numpy()
    img = np.random.RandomState(7).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    got = port(img)["instances"]
    want = ref(img)["instances"]
    assert len(got) == len(want) >= 2
    np.testing.assert_array_equal(got.pred_classes, want.pred_classes)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pred_boxes.tensor, np.asarray(want.pred_boxes.tensor), rtol=0, atol=1e-2)
    assert got.pred_masks.shape == want.pred_masks.shape and got.pred_masks.any()
    assert (got.pred_masks != want.pred_masks).mean() < 1e-3


# -- entry points ----------------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [CASCADE, CASCADE + ["MODEL.MASK_ON", True]], ids=["cascade", "cascade_mask"])
def test_cascade_options_that_raised_build_and_run(extra):
    """``ROI_HEADS.NAME CascadeROIHeads``, with and without ``MASK_ON``,
    raised before this slice (``test_torch_rcnn``'s raise test): they build,
    serve and take a loss with a backward now."""
    _, pcfg = _cfgs(extra)
    pm = build_model(pcfg)
    assert len(pm.model.roi_heads.box_head) == 3 and hasattr(pm.model.roi_heads, "mask_head") == ("MODEL.MASK_ON" in extra)
    dets = pm.predict_fn(_nchw(_images(1, seed=3)))
    assert dets["boxes"].shape == (1, 100, 4) and torch.isfinite(dets["scores"]).all()
    batch = _mask_batch(3)
    pb = _port_batch(batch)
    pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
    pb["generator"] = torch.Generator().manual_seed(0)
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    assert {"loss_cls_stage2", "loss_box_reg_stage2"} <= set(losses) and math.isfinite(total.item())


def test_default_trainer_trains_two_steps_then_evaluates_bbox_and_segm(tmp_path):
    """``configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml`` cut in width
    (ResNet-18, RES2 16, FPN 32, FC_DIM 64, mask convs of 32) and size
    (64², top-ks 200/100 and 100/50, 64 rois), on the synthetic stand-ins:
    2 SGD steps at batch 2, the three stages' losses finite at each, then
    the evaluation: bbox and segm AP dicts."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "Misc", "cascade_mask_rcnn_R_50_FPN_1x.yaml"))
    cfg.merge_from_list([
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
        "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 100, "MODEL.RPN.POST_NMS_TOPK_TEST", 50,
        "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "SOLVER.BASE_LR", 0.002,
        "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2, "TEST.BATCH_SIZE", 2, "DATALOADER.NUM_WORKERS", 1,
        "DATASETS.TRAIN", ("test_torch_cascade_train",), "DATASETS.TEST", ("test_torch_cascade_val",),
        "OUTPUT_DIR", str(tmp_path), "TPU.DTYPE", "float32"])
    ensure_synthetic_datasets(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    trainer = DefaultTrainer(cfg)
    assert isinstance(trainer.model.model.roi_heads.box_head, torch.nn.ModuleList)
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    for t in range(3):
        losses = [v for v, _ in trainer.storage.history(f"loss_cls_stage{t}").values()]
        assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert set(results) == {"bbox", "segm"}
    assert all(math.isfinite(results[t][k]) for t in results for k in ("AP", "AP50", "AP75"))


def test_train_acc_puts_its_overrides_over_the_yaml():
    """``tools/train_acc``'s trailing KEY VALUE pairs go over the accuracy
    YAML, as the JAX package's ``train_net`` takes them: Cascade on the Mask
    R-CNN config, key for key the JAX package's reading of the same."""
    from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
    from detectron2_centernet_tpu_torch.tools import train_acc

    from test_torch_rcnn import _flat

    yaml_file = os.path.join(REPO, "configs", "quick_schedules", "mask_rcnn_synth_training_acc_test.yaml")
    got = train_acc.acc_cfg(yaml_file, seed=43, device="cpu", opts=CASCADE)
    want = jax_get_cfg()
    want.merge_from_file(yaml_file)
    want.merge_from_list(CASCADE + ["SEED", 43])
    got.MODEL.DEVICE = want.MODEL.DEVICE
    assert _flat(got) == _flat(want)
    assert got.MODEL.ROI_HEADS.NAME == "CascadeROIHeads" and got.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG
