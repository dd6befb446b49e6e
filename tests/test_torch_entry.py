"""The port's config files without PyYAML, and its entry points on the CPU.

* The YAML reader (``config/yaml_io.py``) against PyYAML for every
  ``*.yaml`` under ``configs/`` and ``projects/*/configs/``: the same dict
  as the PyYAML-based loader the port used before (a copy of it lives here;
  the port itself never imports PyYAML). For the files under ``configs/``,
  ``merge_from_file`` gives the same config, and ``dump()`` read back
  merges into the same config again.
* ``default_argument_parser`` against the JAX package's, ``default_setup``,
  ``launch``, ``tools/train_net`` (training, then ``--eval-only
  --resume``), ``tools/bench`` (one JSON line), at tiny sizes on the CPU.
"""

import glob
import json
import math
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.engine import default_argument_parser as jax_parser
from detectron2_centernet_tpu_torch.config import CfgNode, get_cfg
from detectron2_centernet_tpu_torch.config import cfgnode
from detectron2_centernet_tpu_torch.config.cfgnode import _load_yaml_with_base
from detectron2_centernet_tpu_torch.config.yaml_io import YamlError, dump_yaml, load_yaml
from detectron2_centernet_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_centernet_tpu_torch.engine import default_argument_parser, default_setup, launch
from detectron2_centernet_tpu_torch.tools import bench, train_net
from detectron2_centernet_tpu_torch.utils.env import seed_all_rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(f, REPO) for f in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                                                             recursive=True))
PROJECT_CONFIGS = sorted(os.path.relpath(f, REPO) for f in glob.glob(
    os.path.join(REPO, "projects", "*", "configs", "**", "*.yaml"), recursive=True))


# -- the PyYAML-based loader the port had, kept here as the reference ----------------


class _ExprLoader(yaml.SafeLoader):
    pass


_ExprLoader.add_constructor(
    "tag:yaml.org,2002:python/object/apply:eval",
    lambda loader, node: eval(loader.construct_sequence(node)[0], {"__builtins__": {}}, {}))  # noqa: S307


def _pyyaml_with_base(filename):
    with open(filename) as f:
        cfg = yaml.load(f, Loader=_ExprLoader) or {}
    if "_BASE_" in cfg:
        base = cfg.pop("_BASE_")
        if not base.startswith("/"):
            base = os.path.join(os.path.dirname(filename), base)
        base_cfg = _pyyaml_with_base(base)
        _merge(cfg, base_cfg)
        return base_cfg
    return cfg


def _merge(over, base):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(v, base[k])
        else:
            base[k] = v


def _same(a, b):
    """Equal, types included (1 is not 1.0 nor True), NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _flat(node, prefix=""):
    out = {}
    for key, val in node.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


def test_there_are_199_config_files():
    assert (len(CONFIGS), len(PROJECT_CONFIGS)) == (120, 79)


@pytest.mark.parametrize("path", CONFIGS + PROJECT_CONFIGS)
def test_yaml_reader_matches_pyyaml(path):
    """The file alone and with its ``_BASE_`` chain: the same dict as
    PyYAML's SafeLoader (with the eval tag), key order and types included."""
    full = os.path.join(REPO, path)
    with open(full) as f:
        text = f.read()
    assert _same(load_yaml(text, path), yaml.load(text, Loader=_ExprLoader))
    assert _same(_load_yaml_with_base(full), _pyyaml_with_base(full))


@pytest.mark.parametrize("path", CONFIGS)
def test_merge_from_file_and_dump_round_trip(path, monkeypatch):
    """``get_cfg().merge_from_file`` with the port's reader gives the config
    that the PyYAML-based loader gives (through the same version upgrade);
    ``dump()``, read back and merged into the defaults, gives it again (a
    value's tuples inside a list or tuple come back as lists: YAML has no
    tuple, and merging restores only the outer one, as yacs does)."""
    full = os.path.join(REPO, path)
    cfg = get_cfg()
    cfg.merge_from_file(full)
    monkeypatch.setattr(cfgnode, "_load_yaml_with_base", _pyyaml_with_base)
    want = get_cfg()
    want.merge_from_file(full)
    monkeypatch.undo()
    assert _flat(cfg) == _flat(want)
    back = get_cfg()
    back.merge_from_other_cfg(CfgNode(load_yaml(cfg.dump())))
    assert _inner_lists(_flat(back)) == _inner_lists(_flat(cfg))
    assert _same(load_yaml(cfg.dump()), yaml.safe_load(cfg.dump()))


def _inner_lists(flat):
    """Tuples below a value's top level as lists."""
    inner = lambda v: [inner(x) for x in v] if isinstance(v, (list, tuple)) else v
    return {k: type(v)(inner(x) for x in v) if isinstance(v, (list, tuple)) else v for k, v in flat.items()}


def test_port_reads_and_writes_configs_without_pyyaml():
    """In a process where ``import yaml`` fails, the port merges a config
    with ``_BASE_`` and the eval tag, dumps it and reads the dump back."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from detectron2_centernet_tpu_torch.config import get_cfg\n"
        "from detectron2_centernet_tpu_torch.config.yaml_io import load_yaml\n"
        "import detectron2_centernet_tpu_torch.engine, detectron2_centernet_tpu_torch.tools.train_net\n"
        "c = get_cfg(); c.merge_from_file('configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml')\n"
        "d = load_yaml(c.dump()); assert d['MODEL']['ANCHOR_GENERATOR']['SIZES'][0][0] == 32\n"
        "c.merge_from_file('configs/COCO-Detection/ctdet_vovnet2_39_1x.yaml')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("text, where", [
    ("A: 1\nB: &x 2\n", "f.yaml:2"), ("A: |\n  text\n", "f.yaml:1"), ("A: !!str 1\n", "f.yaml:1"),
    ("A:\n  B: 1\n C: 2\n", "f.yaml:3"), ("A: [1, 2\n", "f.yaml:1"), ("A: 1\nplain words\n", "f.yaml:2"),
    ("A: 2001-12-14\n", "f.yaml:1"), ("---\nA: 1\n", "f.yaml:1"),
])
def test_yaml_outside_the_subset_raises_with_file_and_line(text, where):
    with pytest.raises(YamlError, match=where):
        load_yaml(text, "f.yaml")


def test_yaml_scalars_resolve_as_pyyaml_and_dump_round_trips():
    """YAML 1.1 resolution (a float needs a dot: 1e-4 is a string), quoting,
    escapes, flow collections over lines; and values the emitter must quote
    or mark to read back the same (strings that look like numbers or
    booleans, 1e-05, inf, nested lists, tuples as lists)."""
    text = ("a: [1, -2, 0x1f, 017, 2.5e-4, 1e-4, .5, -.inf, yes, Off, ~, null, '', 'it''s', \"t\\tab\"]\n"
            "b: {k: v, 'q': [1,\n   2]}\n  # comment\nc:\n- x: 1\n  y: [2]\n- - 3\n  - 4\nd: (1, 2)  # tuple string\n")
    assert _same(load_yaml(text), yaml.safe_load(text))
    data = {"s": ["yes", "1", "1.5", "", "a b", "on", "null", "x:y", "#c", "it's", "é\n"], "f": [1e-05, 0.1, 1e16,
            float("inf"), -0.0], "i": [0, -3], "b": [True, False], "n": None, "l": [[1, [2.5]], []], "t": (1, 2),
            "e": {}, "nested": {"K": {"ON": 1}}}
    out = dump_yaml(data)
    back = load_yaml(out)
    assert _same(back, yaml.safe_load(out))
    data["t"] = [1, 2]
    assert _same(back, {k: data[k] for k in sorted(data)})


# -- entry points ------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [], ["--config-file", "a.yaml", "--eval-only", "--resume", "MODEL.WEIGHTS", "w.pth", "SOLVER.MAX_ITER", "2"],
    ["--num-gpus", "2", "--num-machines", "3", "--machine-rank", "1", "--dist-url", "tcp://h:1", "--resume"],
])
def test_default_argument_parser_parses_as_jax(argv):
    assert vars(default_argument_parser().parse_args(argv)) == vars(jax_parser().parse_args(argv))


def test_launch_runs_in_process_and_refuses_more_processes():
    assert launch(lambda a, b: a + b, args=(2, 3)) == 5
    for kw in ({"num_machines": 2}, {"num_gpus_per_machine": 2}):
        with pytest.raises(NotImplementedError, match="parallel/comm.py"):
            launch(lambda: None, **kw)


def test_seed_all_rng_seeds_python_numpy_and_torch():
    draws = []
    for _ in range(2):
        seed_all_rng(123)
        draws.append((random.random(), np.random.rand(), torch.rand(1).item()))
    assert draws[0] == draws[1]


def test_default_setup_logs_and_writes_a_config_that_merges_back(tmp_path):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", "ctdet_res_18_1x.yaml"))
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp_path), "SEED", 5])
    default_setup(cfg, default_argument_parser().parse_args(["--config-file", "x.yaml"]))
    again = get_cfg()
    again.merge_from_file(str(tmp_path / "config.yaml"))
    assert _inner_lists(_flat(again)) == _inner_lists(_flat(cfg))
    log = (tmp_path / "log.txt").read_text()
    assert "Devices: cpu" in log and "Running with full config" in log


TINY = ["MODEL.DEVICE", "cpu", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16", "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
        "MODEL.CENTERNET.HEAD_CONV", "8", "INPUT.TRAIN_SIZE", "(64, 64)", "INPUT.TEST_SIZE", "(64, 64)",
        "SOLVER.IMS_PER_BATCH", "2", "TEST.BATCH_SIZE", "2", "DATALOADER.NUM_WORKERS", "1",
        "DATASETS.TRAIN", "('test_torch_entry_train',)", "DATASETS.TEST", "('test_torch_entry_val',)"]


def test_train_net_trains_then_resumes_into_eval_only(tmp_path, monkeypatch):
    """``ctdet_res_18_1x.yaml`` (cut in width) for 2 iterations on the CPU
    with synthetic datasets, then ``--eval-only --resume`` on the saved
    checkpoint: the trainer resumes at iteration 2 and the evaluation gives
    the dict the end of training gave."""
    monkeypatch.setenv("DETECTRON2_SYNTH_DATA", "1")
    argv = ["--config-file", os.path.join(REPO, "configs", "COCO-Detection", "ctdet_res_18_1x.yaml"),
            "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(tmp_path)] + TINY
    starts = []
    resume_or_load = train_net.Trainer.resume_or_load

    def recording(self, resume=True):
        resume_or_load(self, resume=resume)
        starts.append(self.start_iter)

    monkeypatch.setattr(train_net.Trainer, "resume_or_load", recording)
    trained = launch(train_net.main, args=(default_argument_parser().parse_args(argv),))
    evaluated = launch(train_net.main,
                       args=(default_argument_parser().parse_args(["--eval-only", "--resume"] + argv),))
    assert starts == [0, 2]
    assert set(trained["bbox"]) >= {"AP", "AP50", "AP75"}
    assert json.dumps(trained, sort_keys=True) == json.dumps(evaluated, sort_keys=True)
    assert (tmp_path / "model_final.pth").exists() and (tmp_path / "config.yaml").exists()


@pytest.mark.parametrize("evaluator_type, evaluator", [pytest.param("cityscapes_sem_seg", "CityscapesSemSegEvaluator",
                                                                    id="cityscapes_sem_seg-A15")])
def test_train_net_formerly_queued_evaluators_build(evaluator_type, evaluator):
    """The evaluator that raised naming its ROADMAP item (A15.2) before it
    was ported builds for its ``evaluator_type``, as the JAX package's
    ``tools/train_net.py`` builds it."""
    name = f"test_torch_entry_{evaluator_type}"
    if name not in DatasetCatalog:
        DatasetCatalog.register(name, lambda: [])
        MetadataCatalog.get(name).set(evaluator_type=evaluator_type)
    assert type(train_net.Trainer.build_evaluator(get_cfg(), name)).__name__ == evaluator


def test_train_net_refuses_test_time_augmentation():
    args = default_argument_parser().parse_args(["TEST.AUG.ENABLED", "True", "MODEL.DEVICE", "cpu"])
    with pytest.raises(NotImplementedError, match="A17"):
        train_net.setup(args)


def test_entry_points_raise_without_a_card(tmp_path):
    """MODEL.DEVICE is cuda by default: train_net and bench raise here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = default_argument_parser().parse_args(
        ["--config-file", os.path.join(REPO, "configs", "COCO-Detection", "ctdet_res_18_1x.yaml"),
         "OUTPUT_DIR", str(tmp_path), "DATASETS.TRAIN", "()", "DATASETS.TEST", "()"])
    with pytest.raises(RuntimeError, match="MODEL.DEVICE=cpu"):
        train_net.main(args)
    with pytest.raises(RuntimeError, match="MODEL.DEVICE=cpu"):
        bench.main([])


@pytest.mark.parametrize("config, tag", [
    ("ctdet_dla_34_1x.yaml", "dla34"), ("ctdet_res_18_1x.yaml", "res18"), ("ctdet_res_50_1x.yaml", "res50"),
    ("ctdet_vovnet2_39_1x.yaml", "vovnet39"), ("ctdet_vovnet2_19_slim_1x.yaml", "vovnet19_slim"),
])
def test_bench_metric_is_named_after_the_backbone(config, tag):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", config))
    assert bench.backbone_tag(cfg) == tag
    cfg.MODEL.VOVNET.CONV_BODY = "V-19-slim-dw-eSE"
    if tag.startswith("vovnet"):
        assert bench.backbone_tag(cfg) == "vovnet19_slim_dw"


def test_bench_prints_one_json_line_in_bench_py_shape(capsys, monkeypatch):
    """The bench on the CPU at a tiny size (fewer calls, requests and steps
    than its defaults): its last line is one JSON object with ``bench.py``'s
    keys, the metric named after the backbone, and the extra keys; the
    card's entries are null on the CPU. The train step is the median of the
    timed steps, which leave out the warm-up steps and the extra step that
    runs last (under the profiler, on a card)."""
    for name, value in (("ITERS", 1), ("REQUESTS", 2), ("REQUEST_WARMUP", 1), ("TRAIN_WARMUP", 1),
                        ("TRAIN_STEPS", 1)):
        monkeypatch.setattr(bench, name, value)
    trained = []
    bench_training = bench.bench_training
    monkeypatch.setattr(bench, "bench_training", lambda cfg: trained.append(bench_training(cfg)) or trained[-1])
    bench.main(["MODEL.DEVICE", "cpu",
                "MODEL.CENTERNET.CHANNELS", "[8, 8, 16, 16, 32, 32]", "MODEL.CENTERNET.HEAD_CONV", "8",
                "INPUT.TEST_SIZE", "(64, 64)", "INPUT.TRAIN_SIZE", "(64, 64)", "TEST.BATCH_SIZE", "2",
                "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "1",
                "DATASETS.TRAIN", "('test_torch_entry_bench',)"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(line)
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert result["metric"] == "ctdet_dla34_64_infer_throughput"
    assert result["unit"] == "img/s/chip" and result["value"] > 0
    assert result["vs_baseline"] == round(result["value"] / 104.0, 3)
    extra = result["extra"]
    assert {"predictor_latency_ms", "train_step_ms", "train_img_s", "train_busy_share", "peak_memory_gib",
            "dtype", "card"} <= set(extra)
    assert extra["dtype"] == "bfloat16" and extra["train_step_ms"] > 0 and extra["card"] is None
    _, trainer, clock = trained[0]
    assert trainer.iter == 3 and len(clock.times) == 2 and clock.profiled_ms > 0
    assert extra["train_step_ms"] == clock.times[1]


@pytest.mark.parametrize("config, metric, baseline", [
    ("ctdet_dla_34_1x.yaml", "ctdet_dla34_512_infer_throughput", 104.0),
    ("ctdet_res_50_1x.yaml", "ctdet_res50_512_infer_throughput", 104.0),
    ("retinanet_R_50_FPN_1x.yaml", "retinanet_res50_fpn_800_infer_throughput", 1 / 0.056),
    ("retinanet_R_101_FPN_3x.yaml", "retinanet_res101_fpn_800_infer_throughput", 1 / 0.056),
    ("faster_rcnn_R_50_FPN_1x.yaml", "faster_rcnn_res50_fpn_800_infer_throughput", 1 / 0.038),
    ("faster_rcnn_R_101_FPN_3x.yaml", "faster_rcnn_res101_fpn_800_infer_throughput", 1 / 0.038),
    ("rpn_R_50_FPN_1x.yaml", "rpn_res50_fpn_800_infer_throughput", None),
])
def test_bench_metric_and_baseline_follow_the_meta_architecture(config, metric, baseline):
    """ctdet keeps its names and ``bench.py``'s 104 img/s; a RetinaNet is
    named ``retinanet_<backbone>_fpn_<size>`` and held against the
    reference MODEL_ZOO's 0.056 s/im that ``bench.py`` gives RetinaNet
    R50-FPN; a Faster R-CNN ``faster_rcnn_<backbone>_fpn_<size>``, against
    the MODEL_ZOO's 0.038 s/im for R50-FPN (``BASELINE.md``); a
    ProposalNetwork ``rpn_...``, against nothing (``BASELINE.md`` has no
    number for it)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", config))
    assert bench.metric_name(cfg) == metric
    assert bench.baseline_img_s(cfg) == (baseline if baseline is None else pytest.approx(baseline))


def test_bench_prints_a_faster_rcnn_line(capsys, monkeypatch):
    """``faster_rcnn_R_50_FPN_1x.yaml`` through the bench on the CPU, cut in
    width (ResNet-18, FPN 32, FC_DIM 64) and size (64², RPN top-ks 100/50,
    64 rois), with fewer calls, requests and steps: the line names Faster
    R-CNN, ``vs_baseline`` is value × 0.038, and the training's losses are
    the four of GeneralizedRCNN."""
    for name, value in (("ITERS", 1), ("REQUESTS", 2), ("REQUEST_WARMUP", 1), ("TRAIN_WARMUP", 1),
                        ("TRAIN_STEPS", 1)):
        monkeypatch.setattr(bench, name, value)
    trained = []
    bench_training = bench.bench_training
    monkeypatch.setattr(bench, "bench_training", lambda cfg: trained.append(bench_training(cfg)) or trained[-1])
    bench.main(["--config-file", os.path.join(REPO, "configs", "COCO-Detection", "faster_rcnn_R_50_FPN_1x.yaml"),
                "MODEL.DEVICE", "cpu", "MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
                "MODEL.RESNETS.STEM_OUT_CHANNELS", "8", "MODEL.FPN.OUT_CHANNELS", "32",
                "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
                "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "100", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "50",
                "MODEL.RPN.PRE_NMS_TOPK_TEST", "100", "MODEL.RPN.POST_NMS_TOPK_TEST", "50",
                "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64", "INPUT.TEST_SIZE", "(64, 64)",
                "INPUT.TRAIN_SIZE", "(64, 64)", "TEST.BATCH_SIZE", "2", "SOLVER.IMS_PER_BATCH", "2",
                "DATALOADER.NUM_WORKERS", "1", "TPU.DTYPE", "float32", "DATASETS.TRAIN", "('test_torch_entry_bench',)"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["metric"] == "faster_rcnn_res18_fpn_64_infer_throughput" and result["value"] > 0
    assert result["vs_baseline"] == round(result["value"] * 0.038, 3)
    _, trainer, _ = trained[0]
    assert type(trainer.model).__name__ == "GeneralizedRCNN"
    for name in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"):
        assert all(math.isfinite(v) for v, _ in trainer.storage.history(name).values()), name


def test_bench_prints_a_retinanet_line(capsys, monkeypatch):
    """``retinanet_R_50_FPN_1x.yaml`` through the bench on the CPU, cut in
    width (ResNet-18, FPN 32) and size (64²), with fewer calls, requests and
    steps: the line names RetinaNet, ``vs_baseline`` is value × 0.056, and
    the training's losses are the RetinaNet's."""
    for name, value in (("ITERS", 1), ("REQUESTS", 2), ("REQUEST_WARMUP", 1), ("TRAIN_WARMUP", 1),
                        ("TRAIN_STEPS", 1)):
        monkeypatch.setattr(bench, name, value)
    trained = []
    bench_training = bench.bench_training
    monkeypatch.setattr(bench, "bench_training", lambda cfg: trained.append(bench_training(cfg)) or trained[-1])
    bench.main(["--config-file", os.path.join(REPO, "configs", "COCO-Detection", "retinanet_R_50_FPN_1x.yaml"),
                "MODEL.DEVICE", "cpu", "MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
                "MODEL.RESNETS.STEM_OUT_CHANNELS", "8", "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.RETINANET.NUM_CONVS", "1",
                "INPUT.TEST_SIZE", "(64, 64)", "INPUT.TRAIN_SIZE", "(64, 64)", "TEST.BATCH_SIZE", "2",
                "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "1", "TPU.DTYPE", "float32",
                "DATASETS.TRAIN", "('test_torch_entry_bench',)"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["metric"] == "retinanet_res18_fpn_64_infer_throughput" and result["value"] > 0
    assert result["vs_baseline"] == round(result["value"] * 0.056, 3)
    assert result["extra"]["batch"] == 2 and result["extra"]["train_batch"] == 2
    _, trainer, _ = trained[0]
    assert type(trainer.model).__name__ == "RetinaNet"
    assert all(math.isfinite(v) for v, _ in trainer.storage.history("loss_cls").values())


def test_chip_smoke_reads_its_configs_as_the_jax_package_does():
    """``chip_smoke.py`` reads its configs from their YAML files (no copy in
    code) with the run's dtype, output directory and seed over them: key
    for key the JAX package's config of the same file and overrides."""
    sys.path.insert(0, REPO)
    import chip_smoke

    for name in ("ctdet_dla_34_1x", "ctdet_res_18_1x", "ctdet_res_50_1x", "ctdet_vovnet2_39_1x"):
        cwd = os.getcwd()
        os.chdir(REPO)
        try:
            got = chip_smoke.ctdet_cfg(name, "float32")
        finally:
            os.chdir(cwd)
        want = jax_get_cfg()
        want.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", name + ".yaml"))
        want.merge_from_list(["TPU.DTYPE", "float32", "OUTPUT_DIR", "output/chip_smoke", "SEED", 0])
        assert _flat(got) == _flat(want), name
