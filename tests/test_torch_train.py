"""The port's ctdet DLA-34 training path against the JAX package, at the
small width (CHANNELS [8, 8, 16, 16, 32, 32], HEAD_CONV 16, 4 classes, 64²):
the train mapper, one full training step (loss terms, every gradient, the
updated parameters and the BatchNorm statistics), the port's
``DefaultTrainer`` on the CPU."""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_centernet_tpu.engine.train_state import TrainState, make_train_step
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.parallel import get_mesh
from detectron2_centernet_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, DatasetMapper
from detectron2_centernet_tpu_torch.data.datasets import register_synthetic_instances
from detectron2_centernet_tpu_torch.engine import DefaultTrainer
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.solver import build_optimizer

SIZE = 64
SMALL = [
    "MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_dla34_backbone",
    "MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
    "MODEL.CENTERNET.TASK.HM", 4, "DATASETS.TRAIN", (), "INPUT.TRAIN_SIZE", (SIZE, SIZE),
    "TPU.DTYPE", "float32", "TPU.DCN_IMPL", "exact", "TEST.EXACT_MODE", True,
    "INPUT.COLOR_JITTER", False, "SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 0,
    "SOLVER.WEIGHT_DECAY", 1e-3,
]


def _cfgs(extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL + list(extra))
    pcfg.merge_from_list(SMALL + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _random_variables(shapes, seed):
    """Every leaf random: kernels N(0, 1/fan_in), the offset convs scaled so
    offsets reach a few pixels (DCN samples off-integer), BN away from
    identity, the hm bias near -2.19."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            if "conv_offset_mask" in path:
                a = a * 0.25
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif path[-2] == "hm_out":
            a = -2.19 + rng.randn(*v.shape) * 0.5
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _batch(seed, n=2, m=6):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(4, 30, (n, m, 2)), SIZE - 1)], -1)
    valid = np.ones((n, m), bool)
    valid[1, 4:] = False
    return {
        "image": rng.uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32),
        "gt_boxes": boxes.astype(np.float32),
        "gt_classes": rng.randint(0, 4, (n, m)).astype(np.int32),
        "gt_valid": valid,
    }


def _port_batch(b):
    return {"image": torch.from_numpy(b["image"].transpose(0, 3, 1, 2).copy()),
            "gt_boxes": torch.from_numpy(b["gt_boxes"]), "gt_classes": torch.from_numpy(b["gt_classes"]),
            "gt_valid": torch.from_numpy(b["gt_valid"])}


@pytest.fixture(scope="module")
def one_step():
    """One SGD step of both packages from the same random variables."""
    jcfg, pcfg = _cfgs()
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed=0)
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, variables["batch_stats"], jbatch), has_aux=True))(variables["params"])
    tx = jax_build_optimizer(jcfg, variables["params"])
    # a copy: the step donates its state, and a donated buffer made from a
    # numpy array on the CPU may be that array's own memory
    state = TrainState.create(jax.tree_util.tree_map(jnp.array, variables), tx)
    new_state, metrics = make_train_step(jm, tx, get_mesh(1))(state, jbatch)
    # the step's optax update applied to the gradients above
    updates, _ = tx.update(jgrads, tx.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)

    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    pm.model.train()
    opt, sched = build_optimizer(pcfg, pm.model)
    for p in pm.model.parameters():  # as SimpleTrainer: unused parameters get 0, as in JAX
        p.grad = torch.zeros_like(p)
    bns = {name: m for name, m in pm.model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    bn_pixels = {}  # pixels per channel at each BatchNorm
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, name=name: bn_pixels.__setitem__(name, inp[0].numel() // inp[0].shape[1]))
        for name, m in bns.items()]
    total, losses = pm.loss_fn(_port_batch(batch))
    for h in hooks:
        h.remove()
    total.backward()
    grads = {k: p.grad.clone() for k, p in pm.model.named_parameters()}
    opt.step()
    sched.step()
    return dict(variables=variables, jloss=jloss, metrics=metrics, jgrads=jgrads,
                new_state=new_state, new_params=new_params, pm=pm, losses=losses, total=total,
                grads=grads, bns=bns, bn_pixels=bn_pixels)


def test_train_step_loss_terms_match_jax(one_step):
    """hm, wh and off losses and the total: 1e-4 relative (f32 through ~40
    layers and 16 DCNs with off-integer samples; BatchNorm on batch
    statistics over maps as small as 2x2 magnifies the rounding)."""
    s = one_step
    for k, v in s["losses"].items():
        np.testing.assert_allclose(v.item(), float(s["jloss"][k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(v.item(), float(s["metrics"][k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(s["total"].item(), float(s["metrics"]["total_loss"]), rtol=1e-4)


def test_train_step_every_gradient_matches_jax(one_step):
    """Every parameter's gradient, in the port's layout: within 1e-2 of that
    gradient's max |value| (f32 sums in another order through the whole
    backward, DCN backward included, magnified by the train-mode BatchNorms:
    the median error is 2e-3), plus 5e-4 of the model's largest gradient for
    the sums that cancel: the DCN biases, whose true gradient is 0 (a
    BatchNorm follows them), and one offset conv, 7% off its own scale but
    4e-4 of the largest."""
    s = one_step
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, s["jgrads"])})
    assert set(want) == set(s["grads"])
    floor = 5e-4 * max(np.abs(w.numpy()).max() for w in want.values())
    for k, g in s["grads"].items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-2 * np.abs(w).max() + floor, k


def test_train_step_updated_params_match_jax(one_step):
    """SGD with momentum and per-group decay at schedule(0) = BASE_LR, the
    optax update of the JAX step applied to the JAX gradients above (the
    jitted step's own gradients come from another XLA program, and its
    parameters differ from these by up to 5e-4): the parameters agree to
    1e-6 of each tensor's scale plus what the gradient tolerance carries
    through one step (BASE_LR times it: the first update is
    BASE_LR · (g + decay · p))."""
    s = one_step
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, s["new_params"])})
    grads = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, s["jgrads"])})
    lr = 0.01
    floor = 5e-4 * max(np.abs(g.numpy()).max() for g in grads.values())
    for k, p in s["pm"].model.named_parameters():
        w = want[k].numpy()
        tol = 1e-6 * max(np.abs(w).max(), 1.0) + lr * (1e-2 * np.abs(grads[k].numpy()).max() + floor)
        assert np.abs(p.detach().numpy() - w).max() <= tol, k


def test_train_step_bn_statistics_match_jax(one_step):
    """Every BatchNorm ran once. Running means: 1e-4 of their scale.
    Running variances: the port folds the biased batch variance into the
    average, as flax does (ROADMAP C6, repaired): equal to JAX's within 5e-4
    relative, at maps down to 2x2 (8 values per channel, where torch's own
    unbiased update would be 8/7 larger in its batch term)."""
    s = one_step
    stats = {"batch_stats": jax.tree_util.tree_map(np.asarray, s["new_state"].batch_stats)}
    want = {k: v for k, v in state_dict_from_jax(stats).items() if "running" in k}
    assert len(s["bn_pixels"]) == len(s["bns"])
    assert min(s["bn_pixels"].values()) == 8
    for name, bn in s["bns"].items():
        mean = want[name + ".running_mean"].numpy()
        np.testing.assert_allclose(bn.running_mean.numpy(), mean, rtol=0,
                                   atol=1e-4 * np.abs(mean).max(), err_msg=name)
        np.testing.assert_allclose(bn.running_var.numpy(), want[name + ".running_var"].numpy(),
                                   rtol=5e-4, atol=1e-7, err_msg=name)


def test_train_mapper_matches_jax():
    """The same dataset dict and RandomState through both mappers: the affine,
    the padded boxes, classes and valid slots are equal; the uint8 images
    agree up to cv2's 1/32 px sample positions (the port warps without cv2,
    ROADMAP C2): mean |difference| below 0.5 and 99% of pixels within 2."""
    name = "test_torch_train_mapper"
    if name not in DatasetCatalog:
        register_synthetic_instances(name, num_images=3)
    jcfg, pcfg = _cfgs(["MODEL.CENTERNET.MAX_OBJS", 8])
    for i, d in enumerate(DatasetCatalog.get(name)):
        want = JaxMapper(jcfg, is_train=True)(d, rng=np.random.RandomState(i))
        got = DatasetMapper(pcfg, is_train=True)(d, rng=np.random.RandomState(i))
        for k in ("warp", "gt_boxes", "gt_classes", "gt_valid", "height", "width", "image_id"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["image"].dtype == want["image"].dtype == np.uint8
        diff = np.abs(got["image"].astype(np.int32) - want["image"].astype(np.int32))
        assert diff.mean() < 0.5 and (diff <= 2).mean() > 0.99, (diff.mean(), (diff <= 2).mean())
        assert got["gt_valid"].sum() > 0


def test_default_trainer_three_steps_on_cpu(tmp_path):
    """DefaultTrainer with MODEL.DEVICE=cpu on the synthetic stand-in for
    coco_2017_train (80 classes), jitter on: 3 steps with finite losses,
    metrics.json and the final checkpoint written; a second trainer resumes
    from it at iteration 3; evaluation raises (not ported)."""
    from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets

    _, cfg = _cfgs()
    cfg.merge_from_list(["DATASETS.TRAIN", ("coco_2017_train",), "INPUT.COLOR_JITTER", True,
                         "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 3, "OUTPUT_DIR", str(tmp_path),
                         "DATALOADER.NUM_WORKERS", 2, "SEED", 1])
    ensure_synthetic_datasets(cfg.DATASETS.TRAIN)
    trainer = DefaultTrainer(cfg)
    assert trainer.model.num_classes == 80 and trainer.model.device_augment is not None
    trainer.resume_or_load(resume=False)
    trainer.train()
    for k in ("hm_loss", "wh_loss", "off_loss", "total_loss"):
        values = [v for v, _ in trainer.storage.history(k).values()]
        assert len(values) == 3 and all(math.isfinite(v) for v in values), k
    lines = [json.loads(x) for x in open(tmp_path / "metrics.json")]
    assert lines[-1]["iteration"] == 2 and math.isfinite(lines[-1]["total_loss"])
    assert os.path.exists(tmp_path / "model_final.pth")
    again = DefaultTrainer(cfg)
    again.resume_or_load(resume=True)
    assert again.start_iter == 3
    for a, b in zip(again.model.model.state_dict().values(), trainer.model.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    again.data_loader.close()
    with pytest.raises(NotImplementedError, match="A10"):
        DefaultTrainer.test(cfg, trainer.model)
