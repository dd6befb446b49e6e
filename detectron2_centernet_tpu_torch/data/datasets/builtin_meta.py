"""COCO's 80 thing classes in official category-id order, its 17 person
keypoints with their left/right flip map, and the metadata every
COCO-trained model uses (a copy of the JAX package's
``data/datasets/builtin_meta.py``; the reference's ``builtin_meta.py``)."""

from typing import Dict, List

# (category_id, name) in official COCO order; ids are non-contiguous
COCO_CATEGORIES: List[tuple] = [
    (1, "person"), (2, "bicycle"), (3, "car"), (4, "motorcycle"), (5, "airplane"),
    (6, "bus"), (7, "train"), (8, "truck"), (9, "boat"), (10, "traffic light"),
    (11, "fire hydrant"), (13, "stop sign"), (14, "parking meter"), (15, "bench"),
    (16, "bird"), (17, "cat"), (18, "dog"), (19, "horse"), (20, "sheep"),
    (21, "cow"), (22, "elephant"), (23, "bear"), (24, "zebra"), (25, "giraffe"),
    (27, "backpack"), (28, "umbrella"), (31, "handbag"), (32, "tie"),
    (33, "suitcase"), (34, "frisbee"), (35, "skis"), (36, "snowboard"),
    (37, "sports ball"), (38, "kite"), (39, "baseball bat"), (40, "baseball glove"),
    (41, "skateboard"), (42, "surfboard"), (43, "tennis racket"), (44, "bottle"),
    (46, "wine glass"), (47, "cup"), (48, "fork"), (49, "knife"), (50, "spoon"),
    (51, "bowl"), (52, "banana"), (53, "apple"), (54, "sandwich"), (55, "orange"),
    (56, "broccoli"), (57, "carrot"), (58, "hot dog"), (59, "pizza"), (60, "donut"),
    (61, "cake"), (62, "chair"), (63, "couch"), (64, "potted plant"), (65, "bed"),
    (67, "dining table"), (70, "toilet"), (72, "tv"), (73, "laptop"), (74, "mouse"),
    (75, "remote"), (76, "keyboard"), (77, "cell phone"), (78, "microwave"),
    (79, "oven"), (80, "toaster"), (81, "sink"), (82, "refrigerator"), (84, "book"),
    (85, "clock"), (86, "vase"), (87, "scissors"), (88, "teddy bear"),
    (89, "hair drier"), (90, "toothbrush"),
]


COCO_PERSON_KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)

COCO_PERSON_KEYPOINT_FLIP_MAP = (
    ("left_eye", "right_eye"), ("left_ear", "right_ear"),
    ("left_shoulder", "right_shoulder"), ("left_elbow", "right_elbow"),
    ("left_wrist", "right_wrist"), ("left_hip", "right_hip"),
    ("left_knee", "right_knee"), ("left_ankle", "right_ankle"),
)


def _get_coco_instances_meta() -> Dict:
    thing_ids = [cid for cid, _ in COCO_CATEGORIES]
    if len(thing_ids) != 80:
        raise AssertionError(f"COCO has 80 thing classes, the table {len(thing_ids)}")
    return {
        "thing_dataset_id_to_contiguous_id": {cid: i for i, cid in enumerate(thing_ids)},
        "thing_classes": [name for _, name in COCO_CATEGORIES],
    }


def get_builtin_metadata(dataset_name: str) -> Dict:
    """The metadata of a builtin family: "coco", or "coco_person" (with the
    person keypoints' names and flip map)."""
    if dataset_name == "coco":
        return _get_coco_instances_meta()
    if dataset_name == "coco_person":
        meta = _get_coco_instances_meta()
        meta.update(keypoint_names=COCO_PERSON_KEYPOINT_NAMES, keypoint_flip_map=COCO_PERSON_KEYPOINT_FLIP_MAP)
        return meta
    raise KeyError(f"No built-in metadata for dataset {dataset_name}")
