"""Weights across from the JAX package: its flax variables tree → the port's
``state_dict``.

The port's module names are the reference fork's torch keys, so one name map
serves both a JAX tree and a reference ``.pth``. ``canonical_key`` maps a
torch key to its flax path: DLA-34 through ``canonical_dla_key``, a copy of
the JAX package's ``checkpoint/dla_import.py`` map; the ResNet and VoVNet
trunks (``backbone.stem.conv1``, ``backbone.res2.0.conv1.norm``,
``backbone.stage2.OSA2_1.layers.0.OSA2_1_0/conv``, ...) to the JAX trunk
under ``backbone/trunk``; the deconv neck (``deconv_layers.N``) to
``backbone/deconvI`` and ``backbone/deconvI_bn``; heads with or without a
tower; RetinaNet's ResNet-FPN (``backbone.bottom_up.<ResNet keys>``,
``backbone.fpn_lateral3``, ``backbone.top_block.p6``) to ``backbone/bottom_up``,
``backbone/fpn_lateral3`` and ``backbone/top_block_p6``, its head
(``head.cls_subnet.{2i}``, ``head.bbox_subnet.{2i}``, ``head.cls_score``,
``head.bbox_pred``) to ``head/cls_tower{i}``, ``head/box_tower{i}``,
``head/cls_score`` and ``head/bbox_pred``, the ema loss normalizer
(``loss_normalizer``) to ``batch_stats/loss_normalizer``; R-CNN's RPN head
(``proposal_generator.rpn_head.{conv,objectness_logits,anchor_deltas}``) to
``rpn_head/...``, its box head (``roi_heads.box_head.fc{i}``,
``roi_heads.box_head.conv{i}``) to ``box_head/...`` and predictor
(``roi_heads.box_predictor.{cls_score,bbox_pred}``) to ``box_predictor/...``,
the mask head (``roi_heads.mask_head.{mask_fcn{i},deconv,predictor}``) to
``mask_head/...`` and the keypoint head
(``roi_heads.keypoint_head.{conv_fcn{i},score_lowres}``) to
``keypoint_head/...``; Cascade's stages (``roi_heads.box_head.{t}.fc1``,
``roi_heads.box_predictor.{t}.cls_score``) to ``box_head_stage{t}/fc1`` and
``box_predictor_stage{t}/cls_score``, and C4's res5 head
(``roi_heads.res5.{b}.conv1``, ``roi_heads.res5.{b}.conv1.norm``) to
``res5_block{b}/conv1`` and ``res5_block{b}/conv1_norm/bn``; a
``DeformBottleneckBlock``'s deformable 3x3 (``res{s}.{b}.conv2.weight``) to
the block's own ``res{s}_block{b}/conv2_kernel`` and its offset conv
(``res{s}.{b}.conv2_offset``) to ``res{s}_block{b}/conv2_offset``; the torch
key of the 3x3 is the same in a plain block, so ``canonical_key`` is told
the deformable blocks (``deform``); the sem-seg head
(``sem_seg_head.{f}.{2k}``, its norm ``.norm``, ``sem_seg_head.predictor``)
to ``{f}_conv{k}``, ``{f}_gn{k}`` and ``predictor`` under ``head``
(``SemanticSegmentor``) or ``sem_seg_head`` (``PanopticFPN``; the owner is
``canonical_key``'s ``sem_seg``).
``torch_key`` is its inverse, and ``state_dict_from_jax`` checks every key
it makes against it.

Layouts (the rules of the JAX package's ``checkpoint/torch_import.py``, run
the other way):
  * conv kernel HWIO → OIHW;
  * BatchNorm ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
    ``running_mean``/``running_var``;
  * dense kernel (I, O) → (O, I); the box head's ``fc1`` consumes pooled
    rois flattened NHWC in the JAX package and NCHW here (as in the
    reference), so its input dim is permuted from (H, W, C) to (C, H, W)
    order, C the width of the map it flattens (the last box-head conv's, or
    the RPN head's input, the FPN's), each Cascade stage's ``fc1`` too;
  * the depthwise ``up_*`` kernel (2f, 2f, 1, C) → (C, 1, 2f, 2f), the
    neck's transposed-conv kernel (4, 4, Cin, Cout) → (Cin, Cout, 4, 4) and
    the mask head's ``deconv`` (2, 2, Cin, Cout) → (Cin, Cout, 2, 2), all
    flipped spatially: torch's transposed conv correlates with the reversed
    kernel, flax's with the kernel as stored;
  * the keypoint head's ``score_lowres``, a flax ``ConvTranspose`` with
    ``transpose_kernel``, (4, 4, K, C) → (C, K, 4, 4), not flipped: flax
    flips a transposed kernel itself, as torch does.
"""

import re
from typing import Container, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["canonical_dla_key", "canonical_key", "jax_shape", "key_options", "port_layout", "state_dict_from_jax",
           "torch_key"]

_LEAF = {"weight": "kernel", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_BN_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_HEAD_TASKS = ("hm", "wh", "reg", "id", "dep", "rot", "dim", "amodel_offset")


def canonical_dla_key(key: str) -> Optional[str]:
    """Torch DLA(Seg)/ctdet state-dict key → flax variables path, or None when
    the key has no flax counterpart (``num_batches_tracked``, the ImageNet
    classifier)."""
    parts = key.split(".")
    if parts and parts[0] == "module":  # DataParallel prefix
        parts = parts[1:]
    if not parts:
        return None
    leaf = parts[-1]
    body = parts[:-1]
    if leaf == "num_batches_tracked" or "fc" in body:
        return None

    out = []
    is_bn = False
    i = 0
    while i < len(body):
        tok = body[i]
        nxt = body[i + 1] if i + 1 < len(body) else None
        if tok == "base_layer":
            out += ["base_layer", "conv" if nxt == "0" else "bn"]
            is_bn = nxt == "1"
            i += 2
            continue
        m = re.fullmatch(r"level([01])", tok)
        if m and nxt is not None and nxt.isdigit():
            idx = int(nxt)  # [conv, bn, relu] * reps
            out += [f"level{m.group(1)}_conv{idx // 3}", "conv" if idx % 3 == 0 else "bn"]
            is_bn = idx % 3 == 1
            i += 2
            continue
        m = re.fullmatch(r"(conv|bn)([12])", tok)
        if m:
            out += [f"conv{m.group(2)}", m.group(1)]
            is_bn = m.group(1) == "bn"
            i += 1
            continue
        if tok == "root" and nxt in ("conv", "bn"):
            out += ["root", "conv", nxt]
            is_bn = nxt == "bn"
            i += 2
            continue
        if tok == "project" and nxt in ("0", "1"):
            out += ["project", "conv" if nxt == "0" else "bn"]
            is_bn = nxt == "1"
            i += 2
            continue
        if re.fullmatch(r"(proj|node)_\d+", tok):
            out.append(tok)
            rest = body[i + 1:]
            # DCN wrapper: conv.conv_offset_mask.* → conv_offset_mask/*,
            # conv.weight/bias → kernel/bias, actf.0.* → bn/*
            if rest[:2] == ["conv", "conv_offset_mask"]:
                out.append("conv_offset_mask")
            elif rest[:2] == ["actf", "0"]:
                out.append("bn")
                is_bn = True
            return _finish(out, leaf, is_bn)
        if tok in _HEAD_TASKS and nxt is not None and nxt.isdigit():
            out += ["heads", f"{tok}_tower" if nxt == "0" else f"{tok}_out"]
            i += 2
            continue
        if tok in _HEAD_TASKS and i == 0 and nxt is None:  # a head without a tower
            out += ["heads", f"{tok}_out"]
            i += 1
            continue
        out.append(tok)
        i += 1
    return _finish(out, leaf, is_bn)


def _finish(out, leaf, is_bn) -> Optional[str]:
    table = _BN_LEAF if is_bn else _LEAF
    if leaf not in table:
        return None
    mapped = table[leaf]
    collection = "batch_stats" if mapped in ("mean", "var") and is_bn else "params"
    return "/".join([collection] + out + [mapped])


_FLAX_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
              "mean": "running_mean", "var": "running_var"}
_OSA_CONV = {"conv": ("", "conv"), "norm": ("", "norm"), "dw_conv3x3": ("_dw", "conv"),
             "dw_norm": ("_dw", "norm"), "pw_conv1x1": ("_pw", "conv"), "pw_norm": ("_pw", "norm")}


def _trunk_to_flax(body, norm: str):
    """The ResNet or VoVNet module path (torch tokens after ``backbone``) →
    (flax tokens after ``backbone/trunk``, whether it is a normalization),
    or None."""
    head = body[0]
    if head == "stem" and len(body) >= 2 and re.fullmatch(r"conv[123]", body[1]):  # ResNet / DeepLab stem
        conv = body[1]
        return (["stem", conv + "_norm", norm], True) if body[2:] == ["norm"] else (["stem", conv], False)
    m = re.fullmatch(r"res(\d)", head)
    if m and len(body) >= 3:
        block = f"res{m.group(1)}_block{body[1]}"
        return ([block, body[2] + "_norm", norm], True) if body[3:] == ["norm"] else ([block, body[2]], False)
    if head == "stem" and len(body) == 2:  # VoVNet stem: stem_K/conv, stem_K/norm
        m = re.fullmatch(r"stem_(\d)/(conv|norm)", body[1])
        return ([f"stem{m.group(1)}", m.group(2)], m.group(2) == "norm") if m else None
    m = re.fullmatch(r"stage(\d)", head)
    if m and len(body) >= 3:
        bm = re.fullmatch(rf"OSA{m.group(1)}_(\d+)", body[1])
        if bm is None:
            return None
        block = f"stage{m.group(1)}_block{int(bm.group(1)) - 1}"
        rest = body[2:]
        if rest[0] == "ese" and rest[1:] == ["fc"]:
            return [block, "ese", "fc"], False
        last = rest[-1].rsplit("/", 1)
        if len(last) != 2:
            return None
        if rest[0] == "layers" and len(rest) == 3 and last[1] in _OSA_CONV:
            suffix, part = _OSA_CONV[last[1]]
            return [block, f"layer{rest[1]}{suffix}", part], part == "norm"
        if rest[0] in ("conv_reduction", "concat") and len(rest) == 2 and last[1] in ("conv", "norm"):
            return [block, "reduction" if rest[0] == "conv_reduction" else "concat", last[1]], last[1] == "norm"
    return None


def _trunk_to_torch(body):
    """The inverse of ``_trunk_to_flax``: flax tokens after ``backbone/trunk``
    → the torch module path after ``backbone``."""
    head = body[0]
    if head == "stem":
        return f"stem.{body[1].removesuffix('_norm')}" + (".norm" if body[1].endswith("_norm") else "")
    m = re.fullmatch(r"res(\d)_block(\d+)", head)
    if m:
        conv = body[1].removesuffix("_norm")
        return f"res{m.group(1)}.{m.group(2)}.{conv}" + (".norm" if body[1].endswith("_norm") else "")
    m = re.fullmatch(r"stem(\d)", head)
    if m:
        return f"stem.stem_{m.group(1)}/{body[1]}"
    m = re.fullmatch(r"stage(\d)_block(\d+)", head)
    s, b = m.group(1), int(m.group(2)) + 1
    osa = f"stage{s}.OSA{s}_{b}"
    if body[1] == "ese":
        return f"{osa}.ese.fc"
    if body[1] == "reduction":
        return f"{osa}.conv_reduction.OSA{s}_{b}_reduction_0/{body[2]}"
    if body[1] == "concat":
        return f"{osa}.concat.OSA{s}_{b}_concat/{body[2]}"
    lm = re.fullmatch(r"layer(\d+)(_dw|_pw)?", body[1])
    name = {v: k for k, v in _OSA_CONV.items()}[(lm.group(2) or "", body[2])]
    return f"{osa}.layers.{lm.group(1)}.OSA{s}_{b}_{lm.group(1)}/{name}"


_RETINA_TOWERS = {"cls_subnet": "cls_tower", "bbox_subnet": "box_tower"}
_RCNN_OWNERS = {("proposal_generator", "rpn_head"): "rpn_head", ("roi_heads", "box_head"): "box_head",
                ("roi_heads", "box_predictor"): "box_predictor", ("roi_heads", "mask_head"): "mask_head",
                ("roi_heads", "keypoint_head"): "keypoint_head", ("roi_heads", "mask_point_head"): "point_head"}
_RCNN_MODULES = {"rpn_head": r"conv|objectness_logits|anchor_deltas", "box_head": r"(conv|fc)\d+",
                 "box_predictor": r"cls_score|bbox_pred",
                 "mask_head": r"mask_fcn\d+|deconv|predictor|reduce_(channel|spatial)_dim_conv|coarse_mask_fc\d+|"
                              r"prediction",
                 "keypoint_head": r"conv_fcn\d+|score_lowres", "point_head": r"fc\d+|predictor"}


def _rcnn_to_flax(body):
    """R-CNN's RPN, box, mask and keypoint heads and Cascade's stages (torch
    tokens) → flax module tokens, or None."""
    stage = None
    if len(body) == 4 and body[:2] in (["roi_heads", "box_head"], ["roi_heads", "box_predictor"]) \
            and body[2].isdigit():
        stage, body = body[2], body[:2] + body[3:]
    owner = _RCNN_OWNERS.get(tuple(body[:2])) if len(body) == 3 else None
    if owner is None or not re.fullmatch(_RCNN_MODULES[owner], body[2]):
        return None
    return [owner if stage is None else f"{owner}_stage{stage}", body[2]]


def _res5_head_to_flax(body, norm: str):
    """C4's res5 head (``roi_heads.res5.{b}.<conv>[.norm]``) → (flax tokens,
    whether it is a normalization), or None."""
    if len(body) in (4, 5) and body[:2] == ["roi_heads", "res5"] and body[2].isdigit() \
            and re.fullmatch(r"conv\d|shortcut", body[3]) and body[4:] in ([], ["norm"]):
        block = f"res5_block{body[2]}"
        return ([block, body[3] + "_norm", norm], True) if body[4:] else ([block, body[3]], False)
    return None


_ASPP_BRANCHES = ["conv1x1", "dilated0", "dilated1", "dilated2"]


def _sem_seg_to_flax(body, owner: str):
    """The sem-seg heads (torch tokens) → (flax tokens under ``owner``,
    whether it is a norm), or None: Semantic FPN's towers
    (``sem_seg_head.{f}.{i}[.norm]``, the convs at the even indices, the
    upsamples between) and ``predictor``; the DeepLab heads' ASPP
    (``aspp.convs.{0-3}``, the pooling branch's ``aspp.convs.4.1``,
    ``aspp.project``), ``low_level_proj`` and ``decoder{i}``; PointRend's
    ``coarse_sem_seg_head.<a coarse head's key>`` (flax ``coarse``) and
    ``point_head.{fc<i>, predictor}``."""
    if body[0] != "sem_seg_head" or len(body) < 2:
        return None
    if body[1] == "coarse_sem_seg_head":
        inner = _sem_seg_to_flax(["sem_seg_head"] + body[2:], owner)
        return ([owner, "coarse"] + inner[0][1:], inner[1]) if inner else None
    if body[1:] == ["predictor"] or (len(body) == 2 and re.fullmatch(r"low_level_proj|decoder\d", body[1])):
        return [owner, body[1]], False
    if len(body) == 3 and body[1] == "point_head" and re.fullmatch(r"fc\d+|predictor", body[2]):
        return [owner, "point_head", body[2]], False
    if body[1:] == ["aspp", "project"]:
        return [owner, "aspp", "project"], False
    if body[1:3] == ["aspp", "convs"] and (body[3:] in (["0"], ["1"], ["2"], ["3"]) or body[3:] == ["4", "1"]):
        branch = "image_pool" if body[3] == "4" else _ASPP_BRANCHES[int(body[3])]
        return [owner, "aspp", branch], False
    if len(body) in (3, 4) and re.fullmatch(r"p\d", body[1]) and body[2].isdigit() and int(body[2]) % 2 == 0 \
            and body[3:] in ([], ["norm"]):
        k = int(body[2]) // 2
        return ([owner, f"{body[1]}_gn{k}"], True) if body[3:] else ([owner, f"{body[1]}_conv{k}"], False)
    return None


def _sem_seg_to_torch(body) -> Optional[str]:
    """The inverse of ``_sem_seg_to_flax`` for flax tokens after the head's
    owner: the torch module path after ``sem_seg_head.``, or None."""
    if body[0] == "coarse":
        inner = _sem_seg_to_torch(body[1:])
        return f"coarse_sem_seg_head.{inner}" if inner else None
    m = re.fullmatch(r"(p\d)_(conv|gn)(\d+)", body[0]) if len(body) == 1 else None
    if m:  # Semantic FPN's towers
        return f"{m.group(1)}.{2 * int(m.group(3))}" + (".norm" if m.group(2) == "gn" else "")
    if len(body) == 1 and re.fullmatch(r"predictor|low_level_proj|decoder\d", body[0]):
        return body[0]
    if len(body) == 2 and body[0] == "point_head":
        return f"point_head.{body[1]}"
    if len(body) == 2 and body[0] == "aspp":
        if body[1] == "project":
            return "aspp.project"
        return "aspp.convs.4.1" if body[1] == "image_pool" else f"aspp.convs.{_ASPP_BRANCHES.index(body[1])}"
    return None


def _retinanet_to_flax(body):
    """The FPN's own and the RetinaNet head's module path (torch tokens) →
    its flax module tokens, or None for any other path."""
    if len(body) == 2 and body[0] == "backbone" and re.fullmatch(r"fpn_(lateral|output)\d", body[1]):
        return body
    if len(body) == 3 and body[:2] == ["backbone", "top_block"] and body[2] in ("p6", "p7"):
        return ["backbone", f"top_block_{body[2]}"]
    if len(body) == 3 and body[0] == "head" and body[1] in _RETINA_TOWERS and body[2].isdigit() \
            and int(body[2]) % 2 == 0:
        return ["head", f"{_RETINA_TOWERS[body[1]]}{int(body[2]) // 2}"]
    if len(body) == 2 and body[0] == "head" and body[1] in ("cls_score", "bbox_pred"):
        return body
    return None


def canonical_key(key: str, norm: str = "bn", trunk: str = "trunk",
                  deform: Container[str] = (), sem_seg: str = "sem_seg_head") -> Optional[str]:
    """Torch key of any ported backbone and its heads → flax variables
    path, or None when the key has no flax counterpart. ``norm`` is the
    flax name of the ResNet trunk's normalization: ``bn`` (BatchNorm and
    FrozenBatchNorm) or ``gn`` (GroupNorm). ``trunk`` is the flax module
    that holds a bare trunk under ``backbone``: ``trunk`` in CenterNet, ""
    in R-CNN's C4 and DC5, whose backbone is the ResNet itself. ``deform``
    names the ``DeformBottleneckBlock``s (``res3_block0``, ...), whose
    deformable 3x3 is the block's ``conv2_kernel``. ``sem_seg`` is the flax
    module of the sem-seg head: ``sem_seg_head`` in PanopticFPN, ``head``
    in SemanticSegmentor."""
    path = _canonical_key(key, norm, trunk, sem_seg)
    if path is not None and deform and path.endswith("/conv2/kernel"):
        block = path.split("/")[-3]
        if block in deform:
            return path[: -len("/conv2/kernel")] + "/conv2_kernel"
    return path


def _canonical_key(key: str, norm: str, trunk: str, sem_seg: str) -> Optional[str]:
    parts = key.split(".")
    if parts and parts[0] == "module":
        parts = parts[1:]
    if parts == ["loss_normalizer"]:
        return "batch_stats/loss_normalizer"
    if len(parts) < 2:
        return canonical_dla_key(key)
    body, leaf = parts[:-1], parts[-1]
    if leaf == "num_batches_tracked":
        return None
    head = _retinanet_to_flax(body) or _rcnn_to_flax(body)
    if head is not None:
        return _finish(head, leaf, False)
    sem = _sem_seg_to_flax(body, sem_seg)
    if sem is not None:
        return _finish(sem[0], leaf, sem[1])
    res5 = _res5_head_to_flax(body, norm)
    if res5 is not None:
        return _finish(res5[0], leaf, res5[1])
    if body[0] == "deconv_layers" and len(body) == 2 and body[1].isdigit():
        stage, role = divmod(int(body[1]), 3)
        if role == 0:
            return _finish(["backbone", f"deconv{stage}"], leaf, False)
        return _finish(["backbone", f"deconv{stage}_bn"], leaf, True) if role == 1 else None
    owner = "bottom_up" if body[:2] == ["backbone", "bottom_up"] else trunk  # the FPN's ResNet, or the trunk
    trunk = body[2:] if owner == "bottom_up" else body[1:]
    if body[0] == "backbone" and trunk and re.fullmatch(r"stem|res\d|stage\d", trunk[0]):
        mapped = _trunk_to_flax(trunk, norm)
        if mapped is None:
            return None
        tokens, is_norm = mapped
        return _finish(["backbone"] + ([owner] if owner else []) + tokens, leaf, is_norm)
    return canonical_dla_key(key)


def torch_key(path: str, towers: bool = True) -> str:
    """Flax variables path (``params/backbone/...``) → the port's key.
    ``towers``: whether the heads have a tower (``hm.2``) or are one conv
    (``hm``)."""
    parts = path.split("/")[1:]  # drop the collection
    if parts[-1] == "conv2_kernel":  # a DeformBottleneckBlock's deformable 3x3
        parts = parts[:-1] + ["conv2", "kernel"]
    body, leaf = parts[:-1], parts[-1]
    if parts == ["loss_normalizer"]:
        return "loss_normalizer"
    if body[:2] in (["backbone", "trunk"], ["backbone", "bottom_up"]):
        prefix = "backbone.bottom_up." if body[1] == "bottom_up" else "backbone."
        return f"{prefix}{_trunk_to_torch(body[2:])}.{_FLAX_LEAF[leaf]}"
    if len(body) > 2 and body[0] == "backbone" and re.fullmatch(r"stem|res\d_block\d+", body[1]):  # R-CNN's trunk
        return f"backbone.{_trunk_to_torch(body[1:])}.{_FLAX_LEAF[leaf]}"
    sem = _sem_seg_to_torch(body[1:]) if len(body) > 1 and body[0] in ("head", "sem_seg_head") else None
    if sem is not None:  # the sem-seg heads
        return f"sem_seg_head.{sem}.{_FLAX_LEAF[leaf]}"
    owners = {v: ".".join(k) for k, v in _RCNN_OWNERS.items()}
    if len(body) == 2 and body[0] in owners:
        return f"{owners[body[0]]}.{body[1]}.{_FLAX_LEAF[leaf]}"
    m = re.fullmatch(r"(box_head|box_predictor)_stage(\d+)", body[0]) if len(body) == 2 else None
    if m:
        return f"roi_heads.{m.group(1)}.{m.group(2)}.{body[1]}.{_FLAX_LEAF[leaf]}"
    m = re.fullmatch(r"res5_block(\d+)", body[0]) if len(body) in (2, 3) else None
    if m:
        conv = body[1].removesuffix("_norm")
        return f"roi_heads.res5.{m.group(1)}.{conv}" + (".norm" if body[1].endswith("_norm") else "") \
            + f".{_FLAX_LEAF[leaf]}"
    if len(body) == 2 and body[0] == "backbone" and re.fullmatch(r"top_block_p[67]", body[1]):
        return f"backbone.top_block.{body[1][-2:]}.{_FLAX_LEAF[leaf]}"
    m = re.fullmatch(r"(cls|box)_tower(\d+)", body[1]) if len(body) == 2 and body[0] == "head" else None
    if m:
        tower = "cls_subnet" if m.group(1) == "cls" else "bbox_subnet"
        return f"head.{tower}.{2 * int(m.group(2))}.{_FLAX_LEAF[leaf]}"
    if len(body) == 2 and body[0] == "backbone" and re.fullmatch(r"deconv\d+(_bn)?", body[1]):
        stage = int(body[1][6:].removesuffix("_bn"))
        return f"deconv_layers.{3 * stage + body[1].endswith('_bn')}.{_FLAX_LEAF[leaf]}"
    out = []
    i = 0
    while i < len(body):
        tok = body[i]
        nxt = body[i + 1] if i + 1 < len(body) else None
        m = re.fullmatch(r"level([01])_conv(\d+)", tok)
        if tok in ("base_layer", "project") or m:
            head = f"level{m.group(1)}" if m else tok
            base = 3 * int(m.group(2)) if m else 0
            out += [head, str(base + (0 if nxt == "conv" else 1))]
            i += 2
        elif tok == "root":  # root/conv/{conv,bn}
            out += ["root", body[i + 2]]
            i += 3
        elif re.fullmatch(r"conv[12]", tok) and nxt in ("conv", "bn"):
            out.append(tok if nxt == "conv" else "bn" + tok[-1])
            i += 2
        elif re.fullmatch(r"(proj|node)_\d+", tok):
            out += [tok] + {None: ["conv"], "conv_offset_mask": ["conv", "conv_offset_mask"],
                            "bn": ["actf", "0"]}[nxt]
            i += 1 if nxt is None else 2
        elif tok == "heads":
            task, part = nxt.rsplit("_", 1)
            out += [task] + ([] if not towers else ["0" if part == "tower" else "2"])
            i += 2
        else:
            out.append(tok)
            i += 1
    return ".".join(out + [_FLAX_LEAF[leaf]])


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _flattened_channels(shapes: Mapping[str, tuple], owner: str) -> int:
    """The width of the pooled map the box head ``owner`` (``box_head``, or
    Cascade's ``box_head_stage{t}``) flattens: its last conv's output, else
    the RPN head's input (the width of the map the rois pool from)."""
    convs = sorted((int(m.group(1)), p) for p in shapes
                   if (m := re.fullmatch(rf"params/{owner}/conv(\d+)/kernel", p)))
    return shapes[convs[-1][1]][-1] if convs else shapes["params/rpn_head/conv/kernel"][2]


def _fc_input_channels(key: str, shapes: Mapping[str, tuple]) -> Optional[int]:
    """For an fc layer that reads a pooled map flattened (NHWC in the JAX
    package, NCHW here), the map's width; None for any other key: the box
    head's ``fc1`` (each Cascade stage's too) and ``CoarseMaskHead``'s
    ``coarse_mask_fc1``, which reads its ``reduce_spatial_dim_conv``."""
    fc1 = re.fullmatch(r"roi_heads\.box_head\.(?:(\d+)\.)?fc1\.weight", key)
    if fc1:
        return _flattened_channels(shapes, "box_head" if fc1.group(1) is None else f"box_head_stage{fc1.group(1)}")
    if key == "roi_heads.mask_head.coarse_mask_fc1.weight":
        return shapes["params/mask_head/reduce_spatial_dim_conv/kernel"][-1]
    return None


def _transposed_conv(key: str) -> bool:
    """A ConvTranspose2d whose kernel crosses from JAX flipped, (k, k, Cin,
    Cout) → (Cin, Cout, k, k)."""
    return key.startswith("deconv_layers.") or key == "roi_heads.mask_head.deconv.weight"


def port_layout(key: str, arr: np.ndarray, shapes: Mapping[str, tuple]) -> np.ndarray:
    """A leaf in the JAX package's layout → the port's, f32, for the port's
    ``key``; ``shapes`` maps the tree's flax paths to their shapes (the
    flattening fc layers read the width of the map they flatten)."""
    arr = np.array(arr, np.float32)  # a writable copy
    if arr.ndim == 4:
        if key.split(".")[-2].startswith("up_"):
            return np.transpose(arr[::-1, ::-1], (3, 2, 0, 1))  # (2f, 2f, 1, C) → (C, 1, 2f, 2f)
        if _transposed_conv(key):
            return np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))  # (k, k, Cin, Cout) → (Cin, Cout, k, k)
        # HWIO → OIHW; the keypoint head's score_lowres (4, 4, K, C) → (C, K, 4, 4), which flax flips itself
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:
        c = _fc_input_channels(key, shapes)
        if c is not None:
            side = int(round((arr.shape[0] // c) ** 0.5))
            arr = arr.reshape(side, side, c, -1).transpose(2, 0, 1, 3).reshape(arr.shape)  # HWC → CHW rows
        return arr.T  # (I, O) → (O, I)
    return arr


def jax_shape(key: str, shape: tuple) -> tuple:
    """The shape of the port's ``key`` in the JAX package's layout (the
    inverse of ``port_layout``'s transposes)."""
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, o, i) if _transposed_conv(key) else (h, w, i, o)
    return tuple(shape[::-1]) if len(shape) == 2 else tuple(shape)


def key_options(model: torch.nn.Module) -> dict:
    """``canonical_key``'s options for a port network (``CenterNetModel``,
    ``RCNNModel``, ``SemSegModel``, ...), read off its modules: the trunk's
    normalization, the flax module of a bare trunk, the deformable blocks and
    the sem-seg head's owner."""
    names = dict(model.named_modules())
    gn = any(isinstance(m, torch.nn.GroupNorm) and re.search(r"(^|\.)(stem|res\d)\.", n) for n, m in names.items())
    deform = {f"{m.group(1)}_block{m.group(2)}" for n, mod in names.items()
              if type(mod).__name__ == "DeformBottleneckBlock" and (m := re.search(r"(res\d)\.(\d+)$", n))}
    return {"norm": "gn" if gn else "bn", "trunk": "trunk" if type(model).__name__ == "CenterNetModel" else "",
            "deform": deform, "sem_seg": "head" if type(model).__name__ == "SemSegModel" else "sem_seg_head"}


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``{'params', 'batch_stats'}`` tree (numpy leaves) as the
    port's ``state_dict``, f32, with ``num_batches_tracked`` = 0 for every
    BatchNorm. Raises if two leaves would share a key or a key does not map
    back to its leaf through ``canonical_key``."""
    flat = _flatten(variables)
    towers = any("_tower/" in p for p in flat)
    norm = "gn" if any("_norm/gn/" in p for p in flat) else "bn"
    trunk = "" if any(re.match(r"\w+/backbone/(stem|res\d_block\d+)/", p) for p in flat) else "trunk"
    deform = {p.split("/")[-2] for p in flat if p.endswith("/conv2_kernel")}
    # SemanticSegmentor's head is "head", as RetinaNet's: RetinaNet's holds only its towers and predictors
    sem_seg = "head" if any(re.match(r"params/head/(?!(cls|box)_tower\d|cls_score/|bbox_pred/)", p)
                            for p in flat) else "sem_seg_head"
    shapes = {p: a.shape for p, a in flat.items()}
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        key = torch_key(path, towers)
        if canonical_key(key, norm, trunk, deform, sem_seg) != path:
            raise ValueError(f"{path} maps to {key}, which maps back to "
                             f"{canonical_key(key, norm, trunk, deform, sem_seg)}")
        if key in out:
            raise ValueError(f"two leaves map to {key}")
        arr = port_layout(key, arr, shapes)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)  # 0-d stays 0-d
        if key.endswith(".running_var"):  # a FrozenBatchNorm drops it when it loads
            out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out
