"""The evaluator protocol and the timed inference loop (counterpart of the
JAX package's ``evaluation/evaluator.py``; the reference's
``DatasetEvaluator`` (``evaluator.py:13``), ``DatasetEvaluators`` (``:55``)
and ``inference_on_dataset`` (``:101-181``)).

The loop takes batches of the test loader (uint8 (N, H, W, 3) images and
their warps, sizes and ids), runs ``predict_fn`` on the model's device and
hands each image's detections, through ``postprocess``, to the evaluator.
Differences from the JAX loop:
* the last batch is not padded: eager PyTorch has no compiled shape to keep;
* on a card, a worker thread copies each batch's images into pinned host
  memory, and the copy to the card is enqueued without waiting
  (``non_blocking``). Batch k is dispatched before batch k-1 is finished:
  its detections are copied into pinned host buffers without waiting and an
  event is recorded after the copy; the host waits on batch k-1's event only
  (a plain ``.cpu()`` would wait for everything queued, batch k included),
  then post-processes and evaluates batch k-1 while the card runs batch k;
* ``LAST_INFERENCE_STATS`` counts the images dispatched after the warm-up
  batches exactly, and holds the whole run when there are no more batches
  than the warm-up; ``wall_s`` is the whole loop's, and on a card
  ``device_s`` sums the span of every batch's forward (with the
  meta-architecture's ``device_postprocess``: the segmentors' label maps)
  on the stream between two CUDA events (the card's busy share of the loop
  is their ratio);
* each image's ``image_id`` reaches the evaluator as the dataset gave it,
  VOC's "000005" and Cityscapes' file names too, where the JAX loop casts
  it with ``int()`` (ROADMAP C22).
"""

import datetime
import logging
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["DatasetEvaluator", "DatasetEvaluators", "inference_on_dataset", "LAST_INFERENCE_STATS"]

# a batch's precomputed proposals, which go to the device with the images (JAX evaluator.py:79)
PROPOSAL_KEYS = ("proposal_boxes", "proposal_valid")
# timing of the most recent inference_on_dataset call (benchmark harnesses)
LAST_INFERENCE_STATS: dict = {}
NUM_WARMUP = 5  # batches before the timers restart, as in the JAX loop


class DatasetEvaluator:
    def reset(self) -> None:
        pass

    def process(self, inputs, outputs) -> None:
        pass

    def evaluate(self) -> Optional[Dict]:
        pass


class DatasetEvaluators(DatasetEvaluator):
    def __init__(self, evaluators: List[DatasetEvaluator]) -> None:
        super().__init__()
        self._evaluators = evaluators

    def reset(self) -> None:
        for evaluator in self._evaluators:
            evaluator.reset()

    def process(self, inputs, outputs) -> None:
        for evaluator in self._evaluators:
            evaluator.process(inputs, outputs)

    def evaluate(self) -> Dict:
        results = {}
        for evaluator in self._evaluators:
            result = evaluator.evaluate()
            if result is not None:
                for k, v in result.items():
                    assert k not in results, f"Different evaluators produce results with the same key {k}"
                    results[k] = v
        return results


def _pinned_batches(data_loader, pin: bool, stats: Dict[str, float]) -> Iterator[Tuple[dict, torch.Tensor]]:
    """(host batch, its images as a tensor) one batch ahead of the caller, in
    a worker thread: the images in pinned host memory when ``pin``.
    ``stats`` gathers the worker's seconds waiting on the loader
    (``loader_s``) and pinning (``pin_s``)."""
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stats.update(loader_s=0.0, pin_s=0.0)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            it = iter(data_loader)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                images = torch.from_numpy(batch["image"])
                if pin:
                    images = images.pin_memory()
                stats["loader_s"] += t1 - t0
                stats["pin_s"] += time.perf_counter() - t1
                if not put((batch, images)):
                    return
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            put(e)
        finally:
            put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=30)


def _sizes(batch) -> List[Tuple[int, int]]:
    """The batch's images' original (height, width)."""
    return [(int(h), int(w)) for h, w in zip(batch["height"].reshape(-1), batch["width"].reshape(-1))]


def inference_on_dataset(
    predict_fn: Callable,
    data_loader,
    evaluator: Optional[Union[DatasetEvaluator, List[DatasetEvaluator]]],
    postprocess: Optional[Callable] = None,
    device: Union[str, torch.device] = "cuda",
    device_postprocess: Optional[Callable] = None,
) -> Dict:
    """Run ``predict_fn`` over every batch, feed the evaluator, report timing.

    predict_fn(images (N, 3, H, W) uint8 on ``device``) -> dict of
    fixed-size detections on ``device``; a batch with precomputed proposals
    (``MODEL.LOAD_PROPOSALS``) also hands it ``proposal_boxes`` and
    ``proposal_valid`` on ``device`` (JAX ``evaluator.py:219-222``);
    postprocess(dets (numpy), warps, orig_sizes) -> list[{"instances": ...}]
    (the meta-architecture's host boundary);
    device_postprocess(dets, warps, orig_sizes) -> dets, on ``device``
    before the copy to the host, when the meta-architecture has one (the
    segmentors' label maps, so the logits stay on the card). The
    evaluator's ``process`` sees (inputs list[dict], outputs list[dict]) as
    in the reference.
    """
    if isinstance(evaluator, list):
        evaluator = DatasetEvaluators(evaluator)
    if evaluator is None:
        evaluator = DatasetEvaluators([])
    evaluator.reset()
    device = torch.device(device)
    on_card = device.type == "cuda"

    start_time = run_start = time.perf_counter()
    total_data_time = total_compute_time = total_eval_time = 0.0
    total = warm_start_total = 0
    forward_events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def dispatch(batch, images):
        """Enqueue one batch: the images to the device, the forward, the
        detections into pinned host buffers; returns what finish() needs."""
        images = images.to(device, non_blocking=True).permute(0, 3, 1, 2).contiguous()
        proposals = [torch.from_numpy(batch[k]).to(device) for k in PROPOSAL_KEYS if k in batch]

        def forward():
            dets = predict_fn(images, *proposals)
            if device_postprocess is None:
                return dets
            return device_postprocess(dets, [np.asarray(w) for w in batch["warp"]], _sizes(batch))

        if not on_card:
            return batch, {k: v.numpy() for k, v in forward().items()}, None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dets = forward()
        end.record()
        forward_events.append((start, end))
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in dets.items()}
        for k, v in dets.items():
            host[k].copy_(v, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return batch, host, copied

    def finish(pending) -> Tuple[float, float]:
        """Wait for a dispatched batch's detections and run the host side.
        Returns (wait seconds, host seconds)."""
        nonlocal total
        batch, host, copied = pending
        t0 = time.perf_counter()
        if copied is not None:
            copied.synchronize()
        dets = {k: np.asarray(v) for k, v in host.items()}
        t1 = time.perf_counter()
        orig_sizes = _sizes(batch)
        warps = [np.asarray(w) for w in batch["warp"]]
        if postprocess is not None:
            outputs = postprocess(dets, warps, orig_sizes)
        else:
            outputs = [{k: v[i] for k, v in dets.items()} for i in range(len(orig_sizes))]
        # the ids as the dataset gave them, strings too (ROADMAP C22)
        inputs = [{"image_id": image_id, "height": h, "width": w}
                  for image_id, (h, w) in zip(batch["image_id"], orig_sizes)]
        evaluator.process(inputs, outputs)
        total += len(orig_sizes)
        return t1 - t0, time.perf_counter() - t1

    pending = None
    worker_stats: Dict[str, float] = {}
    idx = -1
    start_data_time = time.perf_counter()
    for idx, (batch, images) in enumerate(_pinned_batches(data_loader, on_card, worker_stats)):
        total_data_time += time.perf_counter() - start_data_time
        if idx == NUM_WARMUP:
            # finish the last warm-up batch before the timers restart, so its
            # cost stays out of the sustained window
            if pending is not None:
                finish(pending)
                pending = None
            start_time = time.perf_counter()
            total_compute_time = total_eval_time = 0.0
            warm_start_total = total
        start_compute_time = time.perf_counter()
        dispatched = dispatch(batch, images)
        total_compute_time += time.perf_counter() - start_compute_time
        if pending is not None:
            wait_s, host_s = finish(pending)
            total_compute_time += wait_s
            total_eval_time += host_s
        pending = dispatched
        start_data_time = time.perf_counter()
    if pending is not None:
        wait_s, host_s = finish(pending)
        total_compute_time += wait_s
        total_eval_time += host_s

    end_time = time.perf_counter()
    total_time = end_time - start_time
    num_images = max(total, 1)
    logger.info("Total inference time: %s (%.6f s / img on 1 device)",
                str(datetime.timedelta(seconds=total_time)), total_time / num_images)
    logger.info("Inference breakdown: data %.4f s/img, compute %.4f s/img, eval %.4f s/img over %d images",
                total_data_time / num_images, total_compute_time / num_images,
                total_eval_time / num_images, total)
    warm_images = total - warm_start_total
    LAST_INFERENCE_STATS.clear()
    LAST_INFERENCE_STATS.update(
        total_images=total,
        batches=idx + 1,
        data_s=total_data_time,
        compute_s=total_compute_time,
        eval_s=total_eval_time,
        loader_s=worker_stats.get("loader_s", 0.0),
        pin_s=worker_stats.get("pin_s", 0.0),
        warm_wall_s=total_time,
        warm_images=warm_images,
        sustained_img_s=(warm_images / total_time if total_time > 0 else 0.0),
        wall_s=end_time - run_start,
    )
    if on_card:
        LAST_INFERENCE_STATS["device_s"] = sum(s.elapsed_time(e) for s, e in forward_events) / 1e3

    results = evaluator.evaluate()
    if results is None:
        results = {}
    return results
