"""Default configuration tree (a copy of the JAX package's tree, key for key).

Key surface matches the reference's ``detectron2/config/defaults.py`` (v0.2.1
fork, VERSION 2) so its YAML configs — including the fork's CenterNet ctdet
configs — merge cleanly.  Organized here as per-subsystem builder functions.
The port reads ``MODEL.DEVICE`` as the torch device to run on.

The JAX package's additions live under ``INPUT.TRAIN_SIZE`` /
``INPUT.TEST_SIZE`` and the ``TPU`` node; of that node the port reads only
``DTYPE``. Everything else is the reference contract.
"""

from .cfgnode import CfgNode as CN


def _model_defaults() -> CN:
    m = CN()
    m.LOAD_PROPOSALS = False
    m.MASK_ON = False
    m.KEYPOINT_ON = False
    # "cuda" runs on the first CUDA card and raises when there is none;
    # "cpu" runs every op through its plain PyTorch version.
    m.DEVICE = "cuda"
    m.META_ARCHITECTURE = "GeneralizedRCNN"
    m.WEIGHTS = ""
    # Normalization applied after the model divides by 255 when values are <=1
    # (CenterNet-style) or directly when values are pixel-scale (RCNN-style).
    # BGR ImageNet means, matching reference defaults.py:38-42.
    m.PIXEL_MEAN = [103.530, 116.280, 123.675]
    m.PIXEL_STD = [1.0, 1.0, 1.0]

    m.BACKBONE = CN()
    m.BACKBONE.NAME = "build_resnet_backbone"
    m.BACKBONE.FREEZE_AT = 2

    m.FPN = CN()
    m.FPN.IN_FEATURES = []
    m.FPN.OUT_CHANNELS = 256
    m.FPN.NORM = ""
    m.FPN.FUSE_TYPE = "sum"

    m.PROPOSAL_GENERATOR = CN()
    m.PROPOSAL_GENERATOR.NAME = "RPN"
    m.PROPOSAL_GENERATOR.MIN_SIZE = 0

    m.ANCHOR_GENERATOR = CN()
    m.ANCHOR_GENERATOR.NAME = "DefaultAnchorGenerator"
    m.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    m.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    m.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]
    m.ANCHOR_GENERATOR.OFFSET = 0.0

    m.RPN = _rpn_defaults()
    m.ROI_HEADS = _roi_heads_defaults()
    m.ROI_BOX_HEAD = _roi_box_head_defaults()
    m.ROI_BOX_CASCADE_HEAD = _cascade_head_defaults()
    m.ROI_MASK_HEAD = _roi_mask_head_defaults()
    m.ROI_KEYPOINT_HEAD = _roi_keypoint_head_defaults()
    m.POINT_HEAD = _point_head_defaults()
    m.SEM_SEG_HEAD = _sem_seg_head_defaults()
    m.PANOPTIC_FPN = _panoptic_fpn_defaults()
    m.RETINANET = _retinanet_defaults()
    m.CENTERNET = _centernet_defaults()
    m.VOVNET = _vovnet_defaults()
    m.RESNETS = _resnets_defaults()
    m.TRIDENT = _trident_defaults()
    return m


def _trident_defaults() -> CN:
    """TridentNet branch config (reference projects/TridentNet/tridentnet/
    config.py:13-26; folded into the main tree like CENTERNET/VOVNET)."""
    t = CN()
    t.NUM_BRANCH = 3
    t.BRANCH_DILATIONS = [1, 2, 3]
    t.TRIDENT_STAGE = "res4"
    # -1 aggregates all branches at inference (full TridentNet); >=0 runs a
    # single branch (TridentNet Fast; 1 = the recommended middle branch)
    t.TEST_BRANCH_IDX = 1
    return t


def _rpn_defaults() -> CN:
    r = CN()
    r.HEAD_NAME = "StandardRPNHead"
    r.IN_FEATURES = ["res4"]
    r.BOUNDARY_THRESH = -1
    r.IOU_THRESHOLDS = [0.3, 0.7]
    r.IOU_LABELS = [0, -1, 1]
    r.BATCH_SIZE_PER_IMAGE = 256
    r.POSITIVE_FRACTION = 0.5
    r.BBOX_REG_LOSS_TYPE = "smooth_l1"
    r.BBOX_REG_LOSS_WEIGHT = 1.0
    r.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    r.SMOOTH_L1_BETA = 0.0
    r.LOSS_WEIGHT = 1.0
    r.PRE_NMS_TOPK_TRAIN = 12000
    r.PRE_NMS_TOPK_TEST = 6000
    r.POST_NMS_TOPK_TRAIN = 2000
    r.POST_NMS_TOPK_TEST = 1000
    r.NMS_THRESH = 0.7
    return r


def _roi_heads_defaults() -> CN:
    r = CN()
    r.NAME = "Res5ROIHeads"
    r.NUM_CLASSES = 80
    r.IN_FEATURES = ["res4"]
    r.IOU_THRESHOLDS = [0.5]
    r.IOU_LABELS = [0, 1]
    r.BATCH_SIZE_PER_IMAGE = 512
    r.POSITIVE_FRACTION = 0.25
    r.SCORE_THRESH_TEST = 0.05
    r.NMS_THRESH_TEST = 0.5
    r.PROPOSAL_APPEND_GT = True
    # pluggable per-roi heads registered in ROI_HEAD_EXTENSION_REGISTRY
    # (models/roi_heads/extension.py); projects append their extension name
    r.EXTENSIONS = []
    return r


def _roi_box_head_defaults() -> CN:
    b = CN()
    b.NAME = ""
    b.BBOX_REG_LOSS_TYPE = "smooth_l1"
    b.BBOX_REG_LOSS_WEIGHT = 1.0
    b.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    b.SMOOTH_L1_BETA = 0.0
    b.POOLER_RESOLUTION = 14
    b.POOLER_SAMPLING_RATIO = 0
    b.POOLER_TYPE = "ROIAlignV2"
    b.NUM_FC = 0
    b.FC_DIM = 1024
    b.NUM_CONV = 0
    b.CONV_DIM = 256
    b.NORM = ""
    b.CLS_AGNOSTIC_BBOX_REG = False
    b.TRAIN_ON_PRED_BOXES = False
    return b


def _cascade_head_defaults() -> CN:
    c = CN()
    c.BBOX_REG_WEIGHTS = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )
    c.IOUS = (0.5, 0.6, 0.7)
    return c


def _roi_mask_head_defaults() -> CN:
    mh = CN()
    mh.NAME = "MaskRCNNConvUpsampleHead"
    mh.POOLER_RESOLUTION = 14
    mh.POOLER_SAMPLING_RATIO = 0
    mh.NUM_CONV = 0
    mh.CONV_DIM = 256
    mh.NORM = ""
    mh.CLS_AGNOSTIC_MASK = False
    mh.POOLER_TYPE = "ROIAlignV2"
    # CoarseMaskHead (reference projects/PointRend coarse_mask_head.py) +
    # the POINT_HEAD_ON switch its configs pair with it
    mh.FC_DIM = 1024
    mh.NUM_FC = 2
    mh.OUTPUT_SIDE_RESOLUTION = 7
    mh.IN_FEATURES = ["p2"]
    mh.POINT_HEAD_ON = False
    return mh


def _point_head_defaults() -> CN:
    """PointRend point head (reference projects/PointRend config)."""
    ph = CN()
    ph.NAME = "StandardPointHead"
    ph.NUM_CLASSES = 80
    ph.FC_DIM = 256
    ph.NUM_FC = 3
    ph.TRAIN_NUM_POINTS = 196
    ph.OVERSAMPLE_RATIO = 3
    ph.IMPORTANCE_SAMPLE_RATIO = 0.75
    ph.SUBDIVISION_STEPS = 2
    ph.SUBDIVISION_NUM_POINTS = 196
    ph.IN_FEATURES = ["p2"]
    # the coarse head PointRendSemSegHead wraps (reference projects/
    # PointRend/point_rend/config.py COARSE_SEM_SEG_HEAD_NAME)
    ph.COARSE_SEM_SEG_HEAD_NAME = "SemSegFPNHead"
    return ph


def _roi_keypoint_head_defaults() -> CN:
    kh = CN()
    kh.NAME = "KRCNNConvDeconvUpsampleHead"
    kh.POOLER_RESOLUTION = 14
    kh.POOLER_SAMPLING_RATIO = 0
    kh.CONV_DIMS = tuple(512 for _ in range(8))
    kh.NUM_KEYPOINTS = 17
    kh.MIN_KEYPOINTS_PER_IMAGE = 1
    kh.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = True
    kh.LOSS_WEIGHT = 1.0
    kh.POOLER_TYPE = "ROIAlignV2"
    return kh


def _sem_seg_head_defaults() -> CN:
    s = CN()
    s.NAME = "SemSegFPNHead"
    s.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    s.IGNORE_VALUE = 255
    s.NUM_CLASSES = 54
    s.CONVS_DIM = 128
    s.COMMON_STRIDE = 4
    s.NORM = "GN"
    s.LOSS_WEIGHT = 1.0
    # "cross_entropy" or "hard_pixel_mining" (DeepLabCE; reference
    # projects/DeepLab loss.py:6-40, top-k fraction from LOSS_TOP_K)
    s.LOSS_TYPE = "cross_entropy"
    s.LOSS_TOP_K = 0.2
    # DeepLabV3(+) head settings (reference projects/DeepLab config.py:17-21,
    # folded into the main tree like the other project keys)
    s.PROJECT_FEATURES = ["res2"]
    s.PROJECT_CHANNELS = [48]
    s.ASPP_CHANNELS = 256
    s.ASPP_DILATIONS = [6, 12, 18]
    s.ASPP_DROPOUT = 0.1
    return s


def _panoptic_fpn_defaults() -> CN:
    p = CN()
    p.INSTANCE_LOSS_WEIGHT = 1.0
    p.COMBINE = CN()
    p.COMBINE.ENABLED = True
    p.COMBINE.OVERLAP_THRESH = 0.5
    p.COMBINE.STUFF_AREA_LIMIT = 4096
    p.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.5
    return p


def _retinanet_defaults() -> CN:
    r = CN()
    r.NUM_CLASSES = 80
    r.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    r.NUM_CONVS = 4
    r.IOU_THRESHOLDS = [0.4, 0.5]
    r.IOU_LABELS = [0, -1, 1]
    r.PRIOR_PROB = 0.01
    r.SCORE_THRESH_TEST = 0.05
    r.TOPK_CANDIDATES_TEST = 1000
    r.NMS_THRESH_TEST = 0.5
    r.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    r.FOCAL_LOSS_GAMMA = 2.0
    r.FOCAL_LOSS_ALPHA = 0.25
    r.SMOOTH_L1_LOSS_BETA = 0.1
    r.BBOX_REG_LOSS_TYPE = "smooth_l1"
    r.NORM = ""
    # Loss normalizer: "ema" reproduces the reference's momentum-0.9 running
    # foreground count (retinanet.py:91-92,216-218; state rides in
    # batch_stats); "batch" is the stateless in-batch count (this
    # framework's historical default, psum-friendly and resume-exact).
    r.LOSS_NORMALIZER = "batch"
    return r


def _centernet_defaults() -> CN:
    """CenterNet (ctdet) knobs — the fork's addition (defaults.py:466-494)."""
    c = CN()
    c.NUM_CLASSES = 80
    # DLA-34 trunk shape: per-level block counts and channel widths.
    c.LEVELS = [1, 1, 1, 2, 2, 1]
    c.CHANNELS = [16, 32, 64, 128, 256, 512]
    c.DOWN_RATIO = 4
    c.LAST_LEVEL = 5
    c.HEAD_CONV = 256
    c.FINAL_KERNEL = 1
    c.SIZE_DIVISIBILITY = 32
    c.HM_WEIGHT = 1
    c.WH_WEIGHT = 0.1
    c.OFF_WEIGHT = 1
    c.FOCAL_LOSS_ALPHA = [0.25]
    # Head name → #output channels; HM is overwritten with the dataset's
    # number of thing classes at model build time (centernet.py:59-63).
    c.TASK = CN()
    c.TASK.HM = 80
    c.TASK.WH = 2
    c.TASK.REG = 2
    c.SCORE_THRESH_TEST = 0.05
    c.TOPK_CANDIDATES_TEST = 100
    # TPU addition: max ground-truth objects per image (static target-tensor
    # capacity; the reference hardcodes 128 in gen_heatmap).
    c.MAX_OBJS = 128
    return c


def _vovnet_defaults() -> CN:
    v = CN()
    v.CONV_BODY = "V-39-eSE"
    v.OUT_FEATURES = ["stage2", "stage3", "stage4", "stage5"]
    v.NORM = "FrozenBN"
    v.OUT_CHANNELS = 256
    v.BACKBONE_OUT_CHANNELS = 256
    return v


def _resnets_defaults() -> CN:
    r = CN()
    r.DEPTH = 50
    r.OUT_FEATURES = ["res4"]
    r.NUM_GROUPS = 1
    r.NORM = "FrozenBN"
    r.WIDTH_PER_GROUP = 64
    r.STRIDE_IN_1X1 = True
    r.RES5_DILATION = 1
    # DeepLab trunk options (reference projects/DeepLab config.py:24-28)
    r.STEM_TYPE = "basic"  # or "deeplab" (3x 3x3-conv stem)
    r.RES4_DILATION = 1
    r.RES5_MULTI_GRID = [1, 1, 1]
    r.RES2_OUT_CHANNELS = 256
    r.STEM_OUT_CHANNELS = 64
    r.DEFORM_ON_PER_STAGE = [False, False, False, False]
    r.DEFORM_MODULATED = False
    r.DEFORM_NUM_GROUPS = 1
    return r


def _input_defaults() -> CN:
    i = CN()
    i.MIN_SIZE_TRAIN = (800,)
    i.MIN_SIZE_TRAIN_SAMPLING = "choice"
    i.MAX_SIZE_TRAIN = 1333
    i.MIN_SIZE_TEST = 800
    i.MAX_SIZE_TEST = 1333
    i.RANDOM_FLIP = "horizontal"
    i.CROP = CN()
    i.CROP.ENABLED = False
    i.CROP.TYPE = "relative_range"
    i.CROP.SIZE = [0.9, 0.9]
    # reference DeepLab/panoptic semantics: retry windows until no single
    # sem-seg category exceeds this area fraction (1.0 = disabled)
    i.CROP.SINGLE_CATEGORY_MAX_AREA = 1.0
    # TPU additions: rotation/extent augmentation knobs (the reference
    # exposes RandomRotation/RandomExtent programmatically only)
    i.ROTATION = CN()
    i.ROTATION.ENABLED = False
    i.ROTATION.ANGLE = [-10.0, 10.0]
    i.ROTATION.EXPAND = True
    i.ROTATION.SAMPLE_STYLE = "range"
    i.EXTENT = CN()
    i.EXTENT.ENABLED = False
    i.EXTENT.SCALE_RANGE = (0.8, 1.2)
    i.EXTENT.SHIFT_RANGE = (0.2, 0.2)
    i.FORMAT = "BGR"
    i.MASK_FORMAT = "polygon"
    # Fork-added flag (reference defaults.py:91).
    i.DYNAMIC = False
    # --- TPU additions: static network resolutions. XLA compiles one program
    # per shape, so training uses a single fixed (H, W) and testing uses a
    # fixed letterboxed size instead of the reference's dynamic short-edge
    # resize + divisibility padding (SURVEY.md §5 "long-context" analog).
    i.TRAIN_SIZE = (512, 512)
    i.TEST_SIZE = (512, 512)
    # eval-time letterbox via resize+paste (~3x cheaper than warpAffine on
    # the single host core); TEST.EXACT_MODE overrides back to warpAffine
    i.FAST_LETTERBOX = True
    # CenterNet-style train-time augmentation: random scale & shift of the
    # affine crop (Objects-as-Points training recipe).
    i.SCALE_RANGE = (0.6, 1.4)
    i.SHIFT_RANGE = 0.1
    i.COLOR_JITTER = True
    # SSD photometric distortion (reference projects/PointRend
    # color_augmentation.py; used by PointRend/DeepLab sem-seg recipes) —
    # runs on device like COLOR_JITTER
    i.COLOR_AUG_SSD = False
    # side of the fixed per-object gt-mask raster the mapper produces when
    # MODEL.MASK_ON (device crops proposal windows out of it; masks.py)
    i.MASK_RASTER = 64
    return i


def _datasets_defaults() -> CN:
    d = CN()
    d.TRAIN = ()
    d.PROPOSAL_FILES_TRAIN = ()
    d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    d.TEST = ()
    d.PROPOSAL_FILES_TEST = ()
    d.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000
    return d


def _dataloader_defaults() -> CN:
    dl = CN()
    dl.NUM_WORKERS = 4
    dl.ASPECT_RATIO_GROUPING = True
    dl.SAMPLER_TRAIN = "TrainingSampler"
    dl.REPEAT_THRESHOLD = 0.0
    dl.FILTER_EMPTY_ANNOTATIONS = True
    # TPU addition: host-side prefetch depth for the async loader.
    dl.PREFETCH = 2
    # TPU addition: run INPUT.COLOR_JITTER inside the jitted train step
    # (ops/photometric.py) instead of the host mapper; the mapper then ships
    # uint8 pixels.  ~5 ms/image of host work moves to free VPU cycles.
    dl.DEVICE_PHOTOMETRIC = True
    return dl


def _solver_defaults() -> CN:
    s = CN()
    s.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    # WarmupPolyLR (the DeepLab schedule; reference projects/DeepLab config)
    s.POLY_LR_POWER = 0.9
    s.POLY_LR_CONSTANT_ENDING = 0.0
    # "SGD" (reference solver/build.py:93-138) or "ADAM" (the upstream
    # CenterNet recipe for focal-loss heads; not in the reference fork,
    # which approximates it with very-low-LR SGD)
    s.OPTIMIZER = "SGD"
    s.MAX_ITER = 40000
    s.BASE_LR = 0.001
    s.MOMENTUM = 0.9
    s.NESTEROV = False
    s.WEIGHT_DECAY = 0.0001
    s.WEIGHT_DECAY_NORM = 0.0
    s.GAMMA = 0.1
    s.STEPS = (30000,)
    s.WARMUP_FACTOR = 1.0 / 1000
    s.WARMUP_ITERS = 1000
    s.WARMUP_METHOD = "linear"
    s.CHECKPOINT_PERIOD = 5000
    s.IMS_PER_BATCH = 16
    s.REFERENCE_WORLD_SIZE = 0
    s.BIAS_LR_FACTOR = 1.0
    s.WEIGHT_DECAY_BIAS = 0.0001
    s.CLIP_GRADIENTS = CN()
    s.CLIP_GRADIENTS.ENABLED = False
    s.CLIP_GRADIENTS.CLIP_TYPE = "value"
    s.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    s.CLIP_GRADIENTS.NORM_TYPE = 2.0
    return s


def _test_defaults() -> CN:
    t = CN()
    t.EXPECTED_RESULTS = []
    t.EVAL_PERIOD = 0
    t.KEYPOINT_OKS_SIGMAS = []
    t.DETECTIONS_PER_IMAGE = 100
    # Fork-added inference batch size (reference defaults.py:633). TPUs want
    # batch > 1; batch-1 is kept as the apples-to-apples latency mode.
    t.BATCH_SIZE = 1
    t.AUG = CN()
    t.AUG.ENABLED = False
    t.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
    t.AUG.MAX_SIZE = 4000
    t.AUG.FLIP = True
    t.PRECISE_BN = CN()
    t.PRECISE_BN.ENABLED = False
    t.PRECISE_BN.NUM_ITER = 200
    # Exactness switch for accuracy validation (no reference analog — the
    # reference has no accuracy-affecting fast paths to disable). True
    # forces exact top-k candidate selection (TPU.APPROX_TOPK ignored),
    # float32 decode scores, and the exact XLA deformable-conv path
    # (TPU.DCN_IMPL/DCN_WINDOW ignored), making inference bit-comparable
    # to the reference decode semantics.
    t.EXACT_MODE = False
    return t


def _tpu_defaults() -> CN:
    """TPU execution knobs of the JAX package. The PyTorch port reads DTYPE
    (the compute dtype); it accepts the DCN and top-k knobs so existing YAMLs
    merge, but always computes exact DCNv2 and exact top-k."""
    t = CN()
    # Compute dtype for conv/matmul activations: "bfloat16" or "float32".
    t.DTYPE = "bfloat16"
    # Data-parallel axis name used in the device mesh.
    t.MESH_AXIS = "data"
    # Number of devices to shard over; -1 = all local devices.
    t.NUM_DEVICES = -1
    # Deformable-conv offset window (pixels at feature resolution): 0 (the
    # default) = exact unbounded-offset DCNv2, bit-matching the reference's
    # semantics. Setting W > 0 opts into the blocked fast path that CLAMPS
    # offsets to [-W, W] (ops/deform_conv.py) — identical whenever
    # |offset| <= W, but an accuracy-affecting approximation for imported
    # reference weights whose offsets may exceed the window.
    t.DCN_WINDOW = 0
    # Deformable-conv implementation: "auto" uses the Pallas tent-matmul
    # kernel (ops/pallas_dcn.py) for inference forward when supported and
    # the exact XLA path otherwise/for training; "exact" / "window" force
    # the XLA paths; "pallas" forces the kernel.
    t.DCN_IMPL = "auto"
    # Pallas kernel vertical offset coverage (|dy| <= V exact, farther
    # samples drop to zero; horizontal offsets are always exact).
    t.DCN_V_WINDOW = 3
    # candidate selection in ctdet decode via the TPU's hardware PartialReduce
    # (jax.lax.approx_max_k, recall 0.99) instead of the exact sort -- ~4x
    # faster on production shapes; set False for bit-exact reference decode
    t.APPROX_TOPK = True
    return t


def build_default_cfg() -> CN:
    c = CN()
    c.VERSION = 2
    c.MODEL = _model_defaults()
    c.INPUT = _input_defaults()
    c.DATASETS = _datasets_defaults()
    c.DATALOADER = _dataloader_defaults()
    c.SOLVER = _solver_defaults()
    c.TEST = _test_defaults()
    c.TPU = _tpu_defaults()
    c.OUTPUT_DIR = "./output"
    c.SEED = -1
    c.CUDNN_BENCHMARK = False
    c.VIS_PERIOD = 0
    c.GLOBAL = CN()
    c.GLOBAL.HACK = 1.0
    return c


_C = build_default_cfg()
