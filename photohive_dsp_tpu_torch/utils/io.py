"""Input pipeline and resumable corpus runner (counterpart of
``photohive_dsp_tpu/utils/io.py``).

The reference's only durable outputs are text dumps (src/utilities.c:229,
src/image_processing.c:185); its input is a bespoke ``.txt`` fixture format
("W H" header then one "r g b" line per pixel, src/image_processing.c:122)
or a PIL upload (utils.py:30).  Here a streaming corpus runner runs over
10k-100k images with:

  * per-host sharding (host i processes every num_hosts-th sorted path),
    where a mesh of ranks (``parallel.mesh``) counts as one host;
  * a fsync'd watermark file recording completed images, so a preempted
    run resumes where it left off;
  * JSONL output shards with the reference's fixed report schema, written
    exactly once across a crash and a resume.

PIL is imported only to decode png/jpg; ``.txt`` fixtures need none.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch.distributed as dist

from .. import runtime as native_rt
from ..config import ReportConfig
from ..models.batch import run_corpus
from ..parallel.sharding import flat_data_mesh
from ..report import Report


def read_txt_image(path: str) -> np.ndarray:
    """Read the reference's .txt fixture format -> (3, H, W) float32 [0,1].

    Format (src/image_processing.c:122-173): "W H" then H*W lines "r g b"
    with 8-bit values, row-major.  Uses the native C++ parser
    (runtime/native.cpp, ~6x faster than numpy.loadtxt) when the host
    toolchain is available, with a pure-numpy fallback.
    """
    u8 = native_rt.read_txt_u8(path)
    if u8 is not None:
        planar = native_rt.planarize_u8(u8)
        if planar is not None:
            return planar
        return np.moveaxis(u8.astype(np.float32) / 255.0, -1, 0)

    with open(path) as f:
        first = f.readline().split()
        width, height = int(first[0]), int(first[1])
        data = np.loadtxt(f, dtype=np.int64, max_rows=height * width)
    if data.shape != (height * width, 3):
        raise ValueError(f"malformed txt image {path}: {data.shape}")
    if data.min() < 0 or data.max() > 255:
        raise ValueError(f"pixel values outside [0,255] in {path}")
    rgb = data.reshape(height, width, 3).astype(np.float32) / 255.0
    return np.moveaxis(rgb, -1, 0)


def write_txt_image(rgb: np.ndarray, path: str) -> None:
    """Write (3, H, W) [0,1] to the reference .txt format
    (src/image_processing.c:185-201: values truncated to ints)."""
    u8 = np.moveaxis((np.asarray(rgb) * 255.0).astype(np.uint8), 0, -1)
    if native_rt.write_txt_u8(path, u8):
        return
    _, h, w = rgb.shape
    flat = (np.moveaxis(rgb, 0, -1).reshape(-1, 3) * 255.0).astype(np.int64)
    with open(path, "w") as f:
        f.write(f"{w} {h}\n")
        np.savetxt(f, flat, fmt="%d")


def load_image(path: str) -> np.ndarray:
    """Load png/jpg (via PIL) or reference .txt -> (3, H, W) float32."""
    if path.endswith(".txt"):
        return read_txt_image(path)
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return np.moveaxis(arr, -1, 0)


def load_image_u8(path: str) -> np.ndarray:
    """Load png/jpg/.txt -> (H, W, 3) uint8, the layout ``run_corpus``
    sends to the device as it is (the decode to float runs there)."""
    if path.endswith(".txt"):
        u8 = native_rt.read_txt_u8(path)
        if u8 is not None:
            return u8
        return np.moveaxis(
            (read_txt_image(path) * 255.0).round(), 0, -1).astype(np.uint8)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


class Watermark:
    """Durable progress marker: set of completed keys, atomically persisted."""

    def __init__(self, path: str):
        self.path = path
        self.done = set()
        if os.path.exists(path):
            with open(path) as f:
                self.done = {line.strip() for line in f if line.strip()}

    def mark(self, keys) -> None:
        with open(self.path, "a") as f:
            for k in keys:
                f.write(f"{k}\n")
            f.flush()
            os.fsync(f.fileno())
        self.done.update(str(k) for k in keys)

    def __contains__(self, key) -> bool:
        return str(key) in self.done


def _recover_shard(out_path: str) -> set:
    """Keys already present in a JSONL shard, after truncating any torn
    trailing line left by a crash mid-write.

    Reports are written before the watermark advances (at-least-once), so
    a crash inside the flush window leaves lines the watermark doesn't
    know about; skipping keys found here makes re-runs exactly-once."""
    keys = set()
    if not os.path.exists(out_path):
        return keys
    with open(out_path, "rb+") as f:
        data = f.read()
        if data and not data.endswith(b"\n"):
            cut = data.rfind(b"\n") + 1
            f.truncate(cut)
            data = data[:cut]
    for line in data.splitlines():
        try:
            keys.add(str(json.loads(line)["key"]))
        except (ValueError, KeyError):
            continue  # unparseable line: the image will be re-emitted
    return keys


def prefetch_iter(it: Iterable, depth: int) -> Iterator:
    """Run ``it`` in a background thread, ``depth`` items ahead.

    Overlaps host-side work (file read + PNG decode, or a batch's copy to
    the device in ``BatchRunner.run_stream_u8``) with device compute: while
    the card works on item N the thread prepares item N+1.  Exceptions in
    the producer re-raise at the consumer; a consumer that stops early
    releases the thread.
    """
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    abandoned = threading.Event()

    def put(item) -> bool:
        # Bounded put that notices consumer abandonment: without it a
        # consumer that breaks out of the generator would leave this
        # thread blocked on a full queue forever, pinning every buffered
        # item (batches can be device tensors) for the process lifetime.
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            put((done, e))
            return
        put((done, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        abandoned.set()


def parallel_map_iter(fn, items: Iterable, workers: int,
                      depth: int) -> Iterator:
    """Ordered ``map(fn, items)`` with a worker thread pool, ``depth``
    results in flight.

    The decode thread pool for the corpus runner: PIL/libpng and the
    native .txt parser release the GIL, so ``workers`` files decode
    concurrently while results stream out in submission order.  Per-item
    exceptions re-raise at the consumer in order (callers that want to
    skip corrupt files catch around ``fn`` itself).
    """
    if workers <= 1:
        yield from map(fn, items)
        return
    depth = max(depth, 1)  # depth<=0 would otherwise drop every item
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        pending: "queue.SimpleQueue" = queue.SimpleQueue()
        it = iter(items)
        n_in_flight = 0
        exhausted = False
        while True:
            while n_in_flight < depth and not exhausted:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending.put(pool.submit(fn, item))
                n_in_flight += 1
            if n_in_flight == 0:
                return
            yield pending.get().result()
            n_in_flight -= 1


def process_corpus(paths: Iterable[str], output_dir: str,
                   cfg: Optional[ReportConfig] = None, mesh=None,
                   batch_size: int = 32, num_hosts: int = 1,
                   host_id: int = 0, flush_every: int = 64,
                   prefetch: int = 16, decode_workers: int = 4,
                   device="cuda") -> int:
    """Stream a corpus of image files into JSONL report shards, resumably.

    Returns the number of images processed this invocation.  Re-running
    after an interruption skips completed images via the watermark and
    the output shard itself (exactly-once output: reports written in the
    window between a flush and the watermark advance are detected by
    ``_recover_shard`` and not re-emitted).  ``prefetch`` images are
    decoded ahead in the background by a pool of ``decode_workers``
    threads (PIL and the native .txt parser release the GIL),
    overlapping the host input pipeline with device compute;
    ``prefetch=0`` disables ALL background work (strictly sequential
    single-thread decode, for debugging).  Reports are computed on
    ``device`` (``run_corpus``).

    With a ``mesh`` (parallel.mesh.make_mesh) every rank of it calls this
    with the same arguments and runs the same shard of paths through
    ``run_corpus(mesh=...)``; the mesh's rank 0 alone reads the progress
    files, hands the others the paths left to do and writes
    ``reports.{host_id}.jsonl``, ``watermark.{host_id}`` and
    ``skipped.{host_id}.jsonl``, so a mesh acts as one host, as one JAX
    process driving its devices does.  Every rank decodes every image.
    """
    cfg = cfg or ReportConfig()
    writer = mesh is None or (mesh.data_index == 0
                              and mesh.spatial_index == 0)
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, f"reports.{host_id}.jsonl")
    # Durable record of undecodable inputs: resumed runs neither re-decode
    # known-corrupt files nor silently under-cover the corpus (the skip
    # log is the machine-readable account of every key without a report).
    skip_path = os.path.join(output_dir, f"skipped.{host_id}.jsonl")
    my_paths = None
    if writer:
        wm = Watermark(os.path.join(output_dir, f"watermark.{host_id}"))
        emitted = _recover_shard(out_path)
        skipped = set()
        if os.path.exists(skip_path):
            with open(skip_path) as f:
                for line in f:
                    try:
                        skipped.add(json.loads(line)["key"])
                    except (ValueError, KeyError):
                        continue
        my_paths = [p for i, p in enumerate(sorted(paths))
                    if i % num_hosts == host_id
                    and p not in wm and str(p) not in emitted
                    and str(p) not in skipped]
    if mesh is not None:
        # Every rank must run the same images: the writer's list.
        box = [my_paths]
        dist.broadcast_object_list(box, src=0,
                                   group=flat_data_mesh(mesh).data_group)
        my_paths = box[0]

    shapes = {}
    skip_log = open(skip_path, "a") if writer else None
    # images() runs inside prefetch_iter's background thread while the
    # finally below closes the file from the consumer thread; the lock +
    # closed check keep a mid-stream consumer exception from racing the
    # producer into a write-after-close ValueError (the skip record is
    # then simply re-logged on resume — at-least-once).
    skip_lock = threading.Lock()

    def log_skip(p, err) -> None:
        with skip_lock:
            if skip_log is None or skip_log.closed:
                return
            skip_log.write(json.dumps({"key": str(p), "error": err}) + "\n")
            skip_log.flush()

    def load_one(p):
        try:
            return p, load_image_u8(p), None
        except Exception as e:  # corrupt file: record durably and continue
            return p, None, f"{type(e).__name__}: {e}"

    if prefetch <= 0:
        decode_workers = 1

    def images() -> Iterator[Tuple[str, np.ndarray]]:
        decoded = parallel_map_iter(load_one, my_paths, decode_workers,
                                    max(prefetch, 2 * decode_workers))
        for p, img, err in decoded:
            if img is None:
                print(f"skipping {p}: {err}")
                log_skip(p, err)
                continue
            shapes[p] = (img.shape[0], img.shape[1])
            yield p, img

    processed = 0
    pending = []
    reports = run_corpus(prefetch_iter(images(), prefetch), cfg, mesh=mesh,
                         batch_size=batch_size, device=device)
    try:
        if not writer:
            for _ in reports:
                processed += 1
            return processed
        with open(out_path, "a") as out:
            for key, data in reports:
                rep_h, rep_w = shapes[key]
                rep = Report(data, rep_h, rep_w, num_boxes=0, config=cfg)
                out.write(json.dumps({"key": str(key),
                                      "report": rep.to_dict()}))
                out.write("\n")
                pending.append(key)
                processed += 1
                if len(pending) >= flush_every:
                    out.flush()
                    os.fsync(out.fileno())
                    wm.mark(pending)
                    pending = []
            out.flush()
            os.fsync(out.fileno())
            if pending:
                wm.mark(pending)
    finally:
        with skip_lock:
            if skip_log is not None:
                skip_log.close()
    return processed
