"""Shared helpers for the example scripts."""

import argparse


def parse_args(description, extra=None, argv=None):
    """The script's arguments, ``--device`` among them, resolved through
    ``aicamera_tpu_torch.device.resolve_device``: leaving it out means the
    GPU, and with no GPU that raises (``--device cpu`` runs the plain CPU
    path)."""
    ap = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain CPU path)")
    if extra:
        extra(ap)
    args = ap.parse_args(argv)
    from aicamera_tpu_torch.device import resolve_device
    args.device = resolve_device(args.device)
    return args


def demo_frame(hw=(540, 960), seed=0):
    """A deterministic synthetic BGR frame (no asset dependency)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 40, (*hw, 3), np.uint8)
    # paint a few solid rectangles so crops/boxes have structure
    # (sizes scale down for small demo frames)
    rw, rh = min(120, hw[1] // 2), min(160, hw[0] // 2)
    for _ in range(4):
        x, y = rng.integers(0, hw[1] - rw), rng.integers(0, hw[0] - rh)
        w, h = rng.integers(rw // 3, rw), rng.integers(rh // 2, rh)
        frame[y:y + h, x:x + w] = rng.integers(60, 255, 3, np.uint8)
    return frame


def frames(args):
    """The first ``--frames`` BGR frames of ``--input`` (an MJPEG ``.avi``
    or a ``.npy`` of frames, read by the port's ``VideoReader``), else as
    many demo frames."""
    if not args.input:
        for i in range(args.frames):
            yield demo_frame(seed=i)
        return
    from aicamera_tpu_torch.utils.video_io import VideoReader
    reader = VideoReader(args.input, max_frames=args.frames)
    try:
        yield from reader.frames()
    finally:
        reader.release()
