"""Result printing and verification (a copy of the JAX package's
``evaluation/testing.py``; the reference's ``detectron2/evaluation/testing.py``).

``print_csv_format`` (:10-25) emits the structured "copypaste:" lines that
``dev/parse_results.sh`` scrapes; ``verify_results`` (:28-59) enforces
``TEST.EXPECTED_RESULTS`` tolerances; ``flatten_results_dict`` (:61) flattens
nested result dicts for EventStorage.
"""

import logging
import pprint
import sys
from collections import OrderedDict
from typing import Dict, Mapping

logger = logging.getLogger(__name__)

__all__ = ["print_csv_format", "verify_results", "flatten_results_dict"]


def print_csv_format(results: Dict) -> None:
    assert isinstance(results, OrderedDict) or isinstance(results, dict), results
    for task, res in results.items():
        if not isinstance(res, Mapping):
            continue
        important_res = [(k, v) for k, v in res.items() if "-" not in k]
        logger.info("copypaste: Task: {}".format(task))
        logger.info("copypaste: " + ",".join([k[0] for k in important_res]))
        logger.info("copypaste: " + ",".join(["{0:.4f}".format(k[1]) for k in important_res]))


def verify_results(cfg, results: Dict) -> bool:
    expected_results = cfg.TEST.EXPECTED_RESULTS
    if not len(expected_results):
        return True

    ok = True
    for task, metric, expected, tolerance in expected_results:
        actual = results[task].get(metric, None)
        if actual is None:
            ok = False
            continue
        if not (isinstance(actual, (float, int)) and abs(actual - expected) < tolerance):
            ok = False

    logger = logging.getLogger(__name__)
    if not ok:
        logger.error("Result verification failed!")
        logger.error("Expected Results: " + str(expected_results))
        logger.error("Actual Results: " + pprint.pformat(results))
        sys.exit(1)
    else:
        logger.info("Results verification passed.")
    return ok


def flatten_results_dict(results: Dict) -> Dict[str, float]:
    r: Dict[str, float] = {}
    for k, v in results.items():
        if isinstance(v, Mapping):
            v = flatten_results_dict(v)
            for kk, vv in v.items():
                r[k + "/" + kk] = vv
        else:
            r[k] = v
    return r
