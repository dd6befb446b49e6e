"""The port's tools against the JAX package on the CPU: ``utils/analysis.py``
(parameter counts equal JAX's, ``flop_count`` exact on a matmul, K1's
registered formula, ResNet-18 CenterNet at 128² in JAX's band),
``engine/hooks.py``'s ``CallbackHook`` and ``TorchProfiler``,
``model_zoo`` (every table entry's config exists and merges through the
port's YAML reader), ``utils/memory.py::retry_if_oom`` (one retry, no CPU),
``utils/collect_env.py``, and ``tools/export_model.py --run-smoke`` and
``tools/analyze_model.py`` on a narrow ctdet.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.model_zoo.model_zoo import _MODEL_URLS as JAX_MODEL_URLS
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.utils.analysis import parameter_count as jax_parameter_count
from detectron2_centernet_tpu_torch import model_zoo
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.engine import hooks
from detectron2_centernet_tpu_torch.engine.train_loop import TrainerBase
from detectron2_centernet_tpu_torch.model_zoo.model_zoo import _MODEL_URLS
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.ops import dcn
from detectron2_centernet_tpu_torch.tools import analyze_model, export_model
from detectron2_centernet_tpu_torch.utils.analysis import flop_count, parameter_count, parameter_count_table
from detectron2_centernet_tpu_torch.utils.collect_env import collect_env_info
from detectron2_centernet_tpu_torch.utils.memory import retry_if_oom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DLA_YAML = os.path.join(REPO, "configs", "COCO-Detection", "ctdet_dla_34_1x.yaml")
NARROW = ["MODEL.CENTERNET.LEVELS", "[1, 1, 1, 1, 1, 1]", "MODEL.CENTERNET.CHANNELS", "[8, 8, 16, 16, 32, 32]", "MODEL.CENTERNET.HEAD_CONV", "16",
          "MODEL.CENTERNET.TASK.HM", "4", "DATASETS.TRAIN", "()", "TPU.DTYPE", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the narrow convolutions run faster alone than
    split across a shared machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- analysis ------------------------------------------------------------------------------

def test_parameter_count_of_a_nested_mapping():
    """Totals and rollups by prefix, as JAX's ``test_parameter_count_exact``."""
    params = {"backbone": {"conv1": {"kernel": np.zeros((3, 3, 4, 8)), "bias": np.zeros(8)},
                           "conv2": {"kernel": np.zeros((1, 1, 8, 8))}},
              "head": {"fc": {"kernel": np.zeros((8, 2)), "bias": np.zeros(2)}}}
    counts = parameter_count(params)
    assert counts == jax_parameter_count(params)
    assert counts["backbone.conv1"] == 3 * 3 * 4 * 8 + 8 and counts[""] == counts["backbone"] + counts["head"]
    table = parameter_count_table(params)
    assert "backbone" in table and "model" in table


@pytest.mark.parametrize("config, extra", [
    ("COCO-Detection/ctdet_dla_34_1x.yaml", NARROW),
    ("COCO-Detection/retinanet_R_50_FPN_1x.yaml", ["MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", "18",
                                                   "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
                                                   "MODEL.FPN.OUT_CHANNELS", "32", "INPUT.TEST_SIZE", "(64, 64)"]),
], ids=["ctdet_dla34", "retinanet_r18"])
def test_parameter_count_totals_equal_jax(config, extra):
    """A model's parameter total equals JAX's over its ``params`` tree."""
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(os.path.join(REPO, "configs", config))
        cfg.merge_from_list(list(extra))
    pcfg.MODEL.DEVICE = "cpu"
    jm = jax_build_model(jcfg)
    size = tuple(jcfg.INPUT.TEST_SIZE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), size))
    pm = build_model(pcfg)
    want = jax_parameter_count(shapes["params"])[""]
    got = parameter_count(pm.model)
    assert got[""] == want == sum(int(np.prod(v.shape)) for v in flatten_dict(shapes["params"]).values())
    assert got["backbone"] < got[""] and "model" in parameter_count_table(pm.model)


def test_flop_count_of_a_matmul_is_2mnk():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    assert flop_count(lambda x, y: x @ y, a, b) == 2 * 64 * 128 * 32


def test_dcn_flops_come_from_its_registered_formula():
    """K1's custom op counts its contraction and sampling: 2·N·Cout·Cin·9·Ho·Wo
    + 8·N·Cin·9·Ho·Wo (stride 2 here: the output grid's pixels)."""
    x, weight = torch.randn(2, 8, 9, 10), torch.randn(4, 8, 3, 3)
    offset, mask = torch.randn(2, 18, 5, 5), torch.rand(2, 9, 5, 5)
    samples = 2 * 8 * 9 * 5 * 5
    assert flop_count(dcn.modulated_deform_conv, x, offset, mask, weight, None, None, None, False, 2) \
        == 2 * samples * 4 + 8 * samples == dcn.dcn_fwd_flops(x.shape, offset.shape, mask.shape, weight.shape)


def test_flop_count_of_resnet18_centernet_lies_in_jax_band():
    """The JAX test's model (R18 CenterNet at 128²): its forward's FLOPs lie
    in the band JAX's test accepts, 5e8 to 5e10."""
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_resnet_backbone",
                         "MODEL.RESNETS.DEPTH", 18, "INPUT.TEST_SIZE", (128, 128), "MODEL.DEVICE", "cpu",
                         "DATASETS.TRAIN", ()])
    model = build_model(cfg)
    assert parameter_count(model.model)[""] > 1e6
    flops = flop_count(model.predict_fn, torch.zeros(1, 3, 128, 128))
    assert 5e8 < flops < 5e10, flops


# -- hooks -------------------------------------------------------------------------------------

class _Trainer(TrainerBase):
    def __init__(self, log):
        super().__init__()
        self.log = log

    def run_step(self):
        self.log.append(("step", self.iter))


def test_callback_hook_calls_in_order_and_drops_its_functions():
    log = []
    trainer = _Trainer(log)
    hook = hooks.CallbackHook(before_train=lambda t: log.append(("before_train", t.iter)),
                              after_train=lambda t: log.append(("after_train", t.iter)),
                              before_step=lambda t: log.append(("before_step", t.iter)),
                              after_step=lambda t: log.append(("after_step", t.iter)))
    trainer.register_hooks([hook])
    trainer.train(0, 2)
    assert log == [("before_train", 0), ("before_step", 0), ("step", 0), ("after_step", 0), ("before_step", 1),
                   ("step", 1), ("after_step", 1), ("after_train", 2)]
    assert hook._before_step is hook._after_train is None


def test_torch_profiler_traces_only_the_predicates_steps(tmp_path):
    """Steps 1 and 3 of 4 traced, each into its own chrome trace naming that
    step's ops; the others run untraced."""
    log = []

    class Step(_Trainer):
        def run_step(self):
            torch.ones(3).add_(self.iter)
            log.append(self.iter)

    trainer = Step(log)
    profiler = hooks.TorchProfiler(lambda t: t.iter in (1, 3), output_dir=str(tmp_path))
    trainer.register_hooks([profiler])
    trainer.train(0, 4)
    assert log == [0, 1, 2, 3]
    assert profiler.traces == [str(tmp_path / "profiler-trace-iter1.json"), str(tmp_path / "profiler-trace-iter3.json")]
    assert sorted(os.listdir(tmp_path)) == ["profiler-trace-iter1.json", "profiler-trace-iter3.json"]
    for path in profiler.traces:
        names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
        assert "aten::add_" in names


# -- model zoo -----------------------------------------------------------------------------------

def test_zoo_table_is_the_jax_packages():
    assert _MODEL_URLS == JAX_MODEL_URLS and len(_MODEL_URLS) == 50


@pytest.mark.parametrize("config_path", sorted(_MODEL_URLS))
def test_zoo_entry(config_path):
    """The checkpoint URL names its config; the config file is in the
    repository and merges through the port's YAML reader."""
    url = model_zoo.get_checkpoint_url(config_path)
    assert url.startswith("https://dl.fbaipublicfiles.com/detectron2/") and url.endswith(".pkl")
    assert config_path.replace(".yaml", "") in url
    assert os.path.samefile(model_zoo.get_config_file(config_path), os.path.join(REPO, "configs", config_path))
    assert model_zoo.get_config(config_path).MODEL.META_ARCHITECTURE


def test_zoo_unknown_path_raises():
    with pytest.raises(RuntimeError):
        model_zoo.get_checkpoint_url("COCO-Detection/does_not_exist.yaml")
    with pytest.raises(RuntimeError):
        model_zoo.get_config_file("COCO-Detection/does_not_exist.yaml")


def test_zoo_get_builds_on_the_device_and_loads_local_weights_only(tmp_path, monkeypatch):
    """``get`` builds on the config's ``MODEL.DEVICE`` (cuda by default: it
    raises with no card); ``trained=True`` raises naming the file to fetch,
    and loads a local checkpoint through the ``MODEL.WEIGHTS`` loader. The
    config is narrowed onto the CPU here."""
    from detectron2_centernet_tpu_torch.model_zoo import model_zoo as zoo

    path = "COCO-Detection/retinanet_R_50_FPN_1x.yaml"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="MODEL.DEVICE"):
            model_zoo.get(path)
    get_config = zoo.get_config

    def narrow(config_path):
        cfg = get_config(config_path)
        cfg.merge_from_list(["MODEL.DEVICE", "cpu", "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
                             "MODEL.FPN.OUT_CHANNELS", 16, "MODEL.RETINANET.NUM_CONVS", 1])
        return cfg

    monkeypatch.setattr(zoo, "get_config", narrow)
    model = model_zoo.get(path)
    assert model.device == torch.device("cpu")
    with pytest.raises(FileNotFoundError, match=model_zoo.get_checkpoint_url(path)):
        model_zoo.get(path, trained=True)
    state = {k: torch.randn_like(v) if v.is_floating_point() else v for k, v in model.model.state_dict().items()}
    torch.save(state, tmp_path / "local.pth")
    loaded = model_zoo.get(path, trained=True, weights_path=str(tmp_path / "local.pth"))
    for k, v in loaded.model.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)


# -- memory, environment ---------------------------------------------------------------------------

def test_retry_if_oom_empties_the_cache_then_reraises(monkeypatch):
    from detectron2_centernet_tpu_torch.utils import memory

    calls, warned, emptied = [], [], []
    monkeypatch.setattr(memory.logger, "warning", lambda msg, *args: warned.append(msg % args))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))

    @retry_if_oom
    def f(x, fail=1):
        calls.append(x.device.type)
        if len(calls) <= fail:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return x * 2

    out = f(torch.ones(2))
    assert out.tolist() == [2.0, 2.0] and calls == ["cpu", "cpu"] and emptied == [1]
    assert len(warned) == 1 and "emptying the cache" in warned[0]
    calls.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):  # a second OOM is raised: no move to the CPU
        f(torch.ones(2), fail=2)
    assert len(calls) == 2 and emptied == [1, 1]
    calls.clear()

    @retry_if_oom
    def g():
        calls.append(1)
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        g()
    assert calls == [1]


def test_collect_env_reports_torch_and_the_card():
    info = collect_env_info()
    assert f"torch: {torch.__version__}" in info and "card (name, power limit):" in info and "nvcc" in info


# -- the command-line tools ---------------------------------------------------------------------------

def test_export_model_writes_and_smoke_runs_its_artifact(tmp_path, caplog):
    """``tools/export_model --int8 --run-smoke`` on the CPU: model.pt2,
    export_meta.json (16 K1 nodes) and config.yaml, reloaded and run."""
    import logging

    caplog.set_level(logging.INFO)
    out = tmp_path / "export"
    assert export_model.main(["--config-file", DLA_YAML, "--output", str(out), "--batch-size", "1",
                              "--image-size", "64", "64", "--int8", "--run-smoke", "MODEL.DEVICE", "cpu"] + NARROW) == 0
    assert sorted(os.listdir(out)) == ["config.yaml", "export_meta.json", "model.pt2"]
    meta = json.loads((out / "export_meta.json").read_text())
    assert meta["custom_ops"] == {"d2ct.dcn_fwd.default": 16} and meta["int8"] and meta["image_size"] == [64, 64]
    assert "Smoke run OK" in caplog.text
    cfg = get_cfg()
    cfg.merge_from_file(str(out / "config.yaml"))
    assert cfg.MODEL.META_ARCHITECTURE == "CenterNet" and cfg.MODEL.CENTERNET.HEAD_CONV == 16


def test_analyze_model_prints_parameters_and_flops(capsys):
    assert analyze_model.main(["--config-file", DLA_YAML, "--tasks", "parameter", "flop", "--", "MODEL.DEVICE", "cpu",
                               "INPUT.TEST_SIZE", "(64, 64)"] + NARROW) == 0
    out = capsys.readouterr().out
    assert "model" in out and "GFLOPs/image" in out
