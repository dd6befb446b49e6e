"""``MODEL.WEIGHTS`` from a file that is not the port's own checkpoint
(ROADMAP C25): a trunk-only ``.pkl`` under "model" (the reference's
converted ImageNet trunks' form), a full ``.pth`` and a ``.pth`` with extra
and missing keys, all in the reference's torch names, loaded into the JAX
package's ``Checkpointer`` through its ``TrainState`` path (its trainer's)
and its variables path (its predictor's), and into the port's two loaders
(``Checkpointer.load(weights_only=True)``, the trainer's;
``engine/defaults.py::load_weights``, ``DefaultPredictor``'s).

The networks: Mask R-CNN R18-FPN at the small size of
``tests/test_torch_rcnn.py`` (FrozenBN trunk, the box head's ``fc1`` after
a flatten, the mask head's deconv), and the DeepLab V3+ trunk and head
(BatchNorm trunk with the DeepLab stem, ASPP with biases). Both packages
start from one random tree (``init``); the files carry another
(``source``). Every parameter must equal JAX's exactly after the layout
transposes; the leaves nothing matched are the same set in both and keep
their init. A file whose keys are exactly the network's loads strictly in
the port, as the port's own checkpoints do, and gives the file's tensors:
JAX's alignment gives the same except where it pairs a DeepLab head's ASPP
branches out of order (``ASPP_MISPAIRED``, ROADMAP C27). The port's own
checkpoint still loads strictly and resumes.
"""

import logging
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from detectron2_centernet_tpu.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.engine.train_state import TrainState as JaxTrainState
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu_torch.checkpoint import Checkpointer, state_dict_from_jax
from detectron2_centernet_tpu_torch.checkpoint.torch_import import flax_leaves
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.engine import DefaultPredictor
from detectron2_centernet_tpu_torch.engine.defaults import load_weights
from detectron2_centernet_tpu_torch.models import build_model

from test_torch_rcnn import SIZE, SMALL, _random_variables

MASK = ["MODEL.MASK_ON", True, "MODEL.ROI_MASK_HEAD.CONV_DIM", 32]
DEEPLAB = ["MODEL.META_ARCHITECTURE", "SemanticSegmentor", "MODEL.BACKBONE.NAME", "build_resnet_deeplab_backbone",
           "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 32, "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
           "MODEL.RESNETS.STEM_OUT_CHANNELS", 16, "MODEL.RESNETS.NORM", "BN", "MODEL.RESNETS.STEM_TYPE", "deeplab",
           "MODEL.RESNETS.RES5_DILATION", 2, "MODEL.RESNETS.RES5_MULTI_GRID", [1, 2, 4],
           "MODEL.RESNETS.OUT_FEATURES", ["res2", "res5"], "MODEL.SEM_SEG_HEAD.NAME", "DeepLabV3PlusHead",
           "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["res2", "res5"], "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
           "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 5, "MODEL.SEM_SEG_HEAD.COMMON_STRIDE", 4,
           "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "TPU.DTYPE", "float32"]
NETWORKS = {"mask_rcnn": SMALL + MASK, "deeplab_v3_plus": DEEPLAB}
# the trunk's keys in each network, and the prefix a converted ImageNet trunk does not carry
TRUNK_PREFIX = {"mask_rcnn": "backbone.bottom_up.", "deeplab_v3_plus": "backbone."}
# JAX's pairs of a full reference-named file that are not the file's own: its ASPP leaves (conv1x1,
# dilated{i}, image_pool) share no token with the reference's convs.{i}, so the 3x3 branches pair by
# position and the 1x1 and pooling branches swap (ROADMAP C27)
ASPP_MISPAIRED = {"mask_rcnn": set(), "deeplab_v3_plus": {
    f"sem_seg_head.aspp.convs.{i}.{leaf}" for i in ("0", "1", "2", "3", "4.1") for leaf in ("weight", "bias")}}


def _cfgs(name, extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(NETWORKS[name] + list(extra))
    pcfg.merge_from_list(NETWORKS[name] + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _reference_order(state, model):
    """``state`` in the port network's own key order (the reference's module
    registration order, which the alignment's flatten detection reads)."""
    return {k: state[k] for k in model.state_dict() if k in state}


def _write_files(name, source, model, tmp):
    """The three files, in the reference's names, carrying ``source``."""
    ref = _reference_order(state_dict_from_jax(source), model)
    prefix = TRUNK_PREFIX[name]
    paths = {"trunk_pkl": os.path.join(tmp, "trunk.pkl"), "full_pth": os.path.join(tmp, "full.pth"),
             "partial_pth": os.path.join(tmp, "partial.pth")}
    trunk = {k[len(prefix):]: v.numpy() for k, v in ref.items() if k.startswith(prefix) and "stem" in k or
             k.startswith(prefix + "res")}
    with open(paths["trunk_pkl"], "wb") as f:
        pickle.dump({"model": trunk, "__author__": "test", "matching_heuristics": True}, f)
    torch.save({"model": ref}, paths["full_pth"])
    keep = list(ref)[: len(ref) * 2 // 3]  # the heads' last third missing
    partial = {k: ref[k] for k in keep}
    partial["fc.weight"] = torch.randn(1000, ref[keep[-1]].shape[0] if ref[keep[-1]].dim() else 1)
    partial["fc.bias"] = torch.randn(1000)
    torch.save(partial, paths["partial_pth"])
    return paths


class _Network:
    def __init__(self, name, tmp):
        self.name = name
        self.jcfg, self.pcfg = _cfgs(name)
        jm = jax_build_model(self.jcfg)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
        self.init = _random_variables(shapes, 0)
        self.source = _random_variables(shapes, 1)
        self.model = build_model(self.pcfg)
        self.init_state = state_dict_from_jax(self.init)
        self.paths = _write_files(name, self.source, self.model.model, tmp)

    def port_model(self):
        self.model.model.load_state_dict(self.init_state)
        return self.model.model


@pytest.fixture(scope="module", params=sorted(NETWORKS))
def network(request, tmp_path_factory):
    return _Network(request.param, str(tmp_path_factory.mktemp(request.param)))


def _jax_loaded(net, path, train_state):
    """The JAX package's tree after its Checkpointer loads ``path``."""
    if train_state:
        st = JaxTrainState(step=np.zeros((), np.int32), params=net.init["params"],
                           batch_stats=net.init.get("batch_stats", {}), opt_state=None)
        st = JaxCheckpointer(st).load(path)
        tree = {"params": st.params, "batch_stats": st.batch_stats}
    else:
        tree = JaxCheckpointer(net.init).load(path)
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _assert_equal_states(got, want, what):
    bad = [k for k in want if not k.endswith("num_batches_tracked") and not torch.equal(got[k], want[k])]
    assert not bad, f"{what}: {len(bad)} of {len(want)} entries differ from JAX's, e.g. {bad[:5]}"


def _unmatched(state, init_state):
    return {k for k in init_state if not k.endswith("num_batches_tracked") and torch.equal(state[k], init_state[k])}


@pytest.mark.parametrize("file", ["trunk_pkl", "partial_pth"])
@pytest.mark.parametrize("train_state", [True, False], ids=["trainer", "predictor"])
def test_port_loaders_pair_every_tensor_as_jax(network, file, train_state):
    """The trainer's loader (``Checkpointer.load(weights_only=True)``)
    against JAX's ``TrainState`` path, the predictor's (``load_weights``)
    against its variables path: every entry of the port's state equals
    JAX's loaded tree crossed with ``state_dict_from_jax``, exactly; the
    entries nothing matched are the same set (by value against the init,
    which no file carries) and kept their init."""
    path = network.paths[file]
    want = _jax_loaded(network, path, train_state)
    model = network.port_model()
    if train_state:
        Checkpointer(model).load(path, weights_only=True)
    else:
        load_weights(model, path)
    got = model.state_dict()
    _assert_equal_states(got, want, f"{network.name} {file}")
    unmatched = _unmatched(got, network.init_state)
    assert unmatched == _unmatched(want, network.init_state)
    assert unmatched and len(unmatched) < len(want)
    if file == "trunk_pkl":  # the heads are not in a trunk, the whole trunk is
        assert not any(k.startswith(TRUNK_PREFIX[network.name] + "res") for k in unmatched)


@pytest.mark.parametrize("train_state", [True, False], ids=["trainer", "predictor"])
def test_a_file_of_the_whole_network_loads_strictly_as_jax_pairs_it(network, train_state):
    """A full ``.pth`` in the reference's names has exactly the network's
    keys: the port loads it strictly and holds the file's tensors; JAX's
    alignment pairs every one of them the same, but the ASPP branches it
    mispairs (``ASPP_MISPAIRED``)."""
    path = network.paths["full_pth"]
    want = _jax_loaded(network, path, train_state)
    model = network.port_model()
    if train_state:
        Checkpointer(model).load(path, weights_only=True)
    else:
        load_weights(model, path)
    got = model.state_dict()
    ref = torch.load(path)["model"]
    _assert_equal_states(got, ref, f"{network.name}: the file")
    differ = {k for k in want if not k.endswith("num_batches_tracked") and not torch.equal(got[k], want[k])}
    assert differ == ASPP_MISPAIRED[network.name]


@pytest.mark.parametrize("entry", ["DefaultPredictor", "DefaultTrainer"])
def test_entry_points_take_a_pkl_trunk_and_keep_their_own_init_elsewhere(network, entry, tmp_path, caplog,
                                                                         monkeypatch):
    """``MODEL.WEIGHTS`` a trunk-only ``.pkl`` through the entry points
    themselves, from the port's own seeded init: the trunk's entries equal
    JAX's from the same file (its predictor's path for ``DefaultPredictor``,
    its trainer's for ``DefaultTrainer``), every other entry is the port's
    init, and the match table is logged."""
    from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
    from detectron2_centernet_tpu_torch.engine import DefaultTrainer

    path = network.paths["trunk_pkl"]
    cfg = network.pcfg.clone()
    cfg.MODEL.WEIGHTS = path
    fresh = build_model(cfg).model.state_dict()
    caplog.set_level("INFO", logger="detectron2_centernet_tpu_torch.checkpoint.torch_import")
    # an entry point run earlier in this process (tools/train_net's setup_logger) stops the package's records
    # at its own logger; caplog reads them at the root
    monkeypatch.setattr(logging.getLogger("detectron2_centernet_tpu_torch"), "propagate", True)
    if entry == "DefaultPredictor":
        got = DefaultPredictor(cfg).model.model.state_dict()
    else:
        name = f"test_torch_checkpoint_import_{network.name}"
        train = "synth_learnable_semseg" if network.name.startswith("deeplab") else name
        cfg.DATASETS.TRAIN, cfg.OUTPUT_DIR = (train,), str(tmp_path)
        ensure_synthetic_datasets([train])
        trainer = DefaultTrainer(cfg)
        try:
            trainer.resume_or_load(resume=False)
        finally:
            trainer.data_loader.close()
        got = trainer.model.model.state_dict()
    want = _jax_loaded(network, path, entry == "DefaultTrainer")
    matched = {k for k in want if not k.endswith("num_batches_tracked")} - _unmatched(want, network.init_state)
    assert matched and all(torch.equal(got[k], want[k]) for k in matched)
    rest = [k for k in fresh if k not in matched and not k.endswith("num_batches_tracked")]
    assert rest and all(torch.equal(got[k], fresh[k]) for k in rest)
    assert "weight match table" in caplog.text


def test_own_checkpoint_loads_strictly_and_resumes(network, tmp_path, monkeypatch):
    """A checkpoint the port's ``Checkpointer`` saved (state, optimizer,
    scheduler, iteration) loads strictly, without the alignment, and
    resumes at the next iteration with the optimizer's state; a file that
    is not this network's checkpoint cannot be resumed from."""
    from detectron2_centernet_tpu_torch.checkpoint import torch_import

    model = network.port_model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    saved = Checkpointer(model, str(tmp_path), optimizer=opt).save("model_0000006", 6)
    monkeypatch.setattr(torch_import, "load_torch_weights", lambda *a, **k: pytest.fail("aligned its own checkpoint"))
    other = build_model(network.pcfg).model
    opt2 = torch.optim.SGD(other.parameters(), lr=0.1, momentum=0.9)
    ckpt = Checkpointer(other, str(tmp_path), optimizer=opt2)
    assert ckpt.resume_or_load(network.paths["trunk_pkl"], resume=True) == 7
    _assert_equal_states(other.state_dict(), model.state_dict(), "resumed")
    moms = [opt2.state[p]["momentum_buffer"] for p in other.parameters()]
    assert all(torch.equal(m, opt.state[p]["momentum_buffer"]) for m, p in zip(moms, model.parameters()))
    assert Checkpointer(other).load(saved, weights_only=True) == 0
    with pytest.raises(ValueError, match="not a checkpoint of this network"):
        Checkpointer(other).load(network.paths["partial_pth"])


def test_flax_leaves_follow_the_jax_flatten_order(network):
    """The port lists its leaves as ``jax.tree_util`` flattens the JAX tree
    (dict keys sorted at every level), with the JAX shapes: the order the
    alignment's position tiebreak reads."""
    want = [("/".join(str(p.key) for p in path), leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(network.init)[0]]
    got = [(p, s) for p, _, s in flax_leaves(network.model.model)]
    assert got == want
