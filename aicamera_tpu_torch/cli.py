"""AICamera CLI on PyTorch/CUDA: object detection + tracking on video.

The port of ``aicamera_tpu/cli.py``: the same flags under the same names,
defaults and aliases, except that ``--device`` defaults to ``cuda`` (and
accepts ``cpu``). Frames in (an MJPEG ``.avi`` or a ``.npy`` file of frames,
``utils/video_io.py``), tracks drawn (``utils/visualization.py``) and the
annotated video written as an MJPEG ``.avi`` unless ``--no_save``;
``--draw_detections``, ``--native_io`` (the C++ MJPEG decoder), tracker
state checkpointed and resumed. The webcam and ``--show_display`` are not
ported (no V4L2 capture, no GUI toolkit): such a run exits with a message
that names the flag rather than carrying on without what it asked for.

Run: ``python -m aicamera_tpu_torch.cli --input clip.avi``
"""

from __future__ import annotations

import argparse
import contextlib
import time
from datetime import datetime
from pathlib import Path

from . import config


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="AICamera: Real-time Object Detection & Tracking "
                    "(PyTorch/CUDA)")
    parser.add_argument("--input", type=str, default=None,
                        help="Path to the input: an MJPEG .avi, or a .npy "
                             "file holding an (N, H, W, 3) uint8 array of "
                             "BGR frames. If None, webcam (not ported).")
    parser.add_argument("--webcam_id", type=int, default=0,
                        help="Webcam ID used when --input is not given "
                             "(not ported).")
    parser.add_argument("--output_dir", type=str, default="outputs",
                        help="Directory for the output video (MJPEG .avi).")
    parser.add_argument("--output_filename", type=str, default=None,
                        help="Output video filename (auto-generated if None).")
    parser.add_argument("--show_display", action="store_true",
                        help="Show processed frames in a window (not "
                             "ported: no GUI toolkit).")
    parser.add_argument("--no_save", action="store_true",
                        help="Do not save the output video.")
    parser.add_argument("--yolo_weights", "--yolo_engine", type=str,
                        default=None, dest="yolo_weights",
                        help="YOLO weights (.msgpack or .onnx).")
    parser.add_argument("--reid_weights", "--reid_engine", type=str,
                        default=None, dest="reid_weights",
                        help="ReID weights (.msgpack or .onnx).")
    parser.add_argument("--conf_thresh", type=float,
                        default=config.YOLO_CONF_THRESHOLD,
                        help="Confidence threshold for YOLO detections.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device: 'cuda' (default) or 'cpu'.")
    parser.add_argument("--variant", type=str, default="n",
                        choices=("n", "s", "m", "l", "x"),
                        help="YOLOv8 variant.")
    parser.add_argument("--tracker", type=str, default="deepsort",
                        choices=("deepsort", "strongsort", "bytetrack",
                                 "botsort", "ocsort", "deepocsort"),
                        help="Tracking algorithm: 'deepsort' (appearance + "
                             "motion), 'strongsort' (DeepSORT + the "
                             "StrongSORT preset: EMA appearance bank, NSA "
                             "Kalman, gmc=affine unless --gmc overrides), "
                             "'bytetrack' (motion-"
                             "only two-pass association over high and low "
                             "score boxes; no ReID stage), 'botsort' "
                             "(ByteTrack + BoT-SORT appearance fusion), "
                             "'ocsort' (observation-centric motion "
                             "tracking; no ReID stage) or 'deepocsort' "
                             "(OC-SORT + Deep OC-SORT's adaptively weighted "
                             "appearance fusion).")
    parser.add_argument("--gallery_strategy", type=str, default="fifo",
                        choices=("fifo", "ema"),
                        help="DeepSORT appearance memory: 'fifo' ring of "
                             "raw features or 'ema', one exponential-"
                             "moving-average embedding per track.")
    parser.add_argument("--ema_alpha", type=float, default=0.9,
                        help="EMA blend factor for --gallery_strategy ema "
                             "(higher = slower-moving appearance bank).")
    parser.add_argument("--nsa", action="store_true",
                        help="Noise-scale-adaptive Kalman updates "
                             "(StrongSORT): scale measurement noise by "
                             "(1 - detection confidence). DeepSORT tracker "
                             "only.")
    parser.add_argument("--gmc", type=str, default=None,
                        choices=("off", "affine", "translation"),
                        help="Camera-motion compensation: block phase "
                             "correlation + robust affine (or translation) "
                             "fit on the device. Default: off ('affine' "
                             "when --tracker strongsort).")
    parser.add_argument("--reid_quant", type=str, default=None,
                        choices=("none", "int8"),
                        help="ReID embedder precision: 'int8' runs the "
                             "W8A8 post-training-quantized embed stage "
                             "(per-channel int8 weights, per-crop dynamic "
                             "activation scales, int32 accumulation). "
                             "Default: bf16.")
    parser.add_argument("--yolo_quant", type=str, default=None,
                        choices=("none", "int8"),
                        help="Detector precision: 'int8' runs the static-"
                             "calibrated W8A8 detector twin (activations "
                             "int8 between convolutions), calibrated once "
                             "at startup on synthetic scenes. Default: "
                             "bf16.")
    parser.add_argument("--detect_dtype", type=str, default=None,
                        choices=("bf16", "f32"),
                        help="Detect-forward precision: default bf16 on the "
                             "GPU; 'f32' (TF32 off) makes NMS scores "
                             "batch-shape-stable.")
    parser.add_argument("--reid_dtype", type=str, default=None,
                        choices=("bf16", "f32"),
                        help="ReID-embed precision: 'f32' makes features "
                             "stable across embed batch shapes.")
    parser.add_argument("--input_shape", type=int, default=None,
                        help="Detector input size (square; default "
                             f"{config.YOLO_INPUT_SHAPE[0]}).")
    parser.add_argument("--auto_input", action="store_true",
                        help="Letterbox 'auto' mode: convolve the "
                             "minimum stride-32 rectangle instead of the "
                             "full square canvas.")
    parser.add_argument("--chunk_size", type=int, default=8,
                        help="Frames per device step (throughput knob; "
                             "1 = lowest latency).")
    parser.add_argument("--max_frames", type=int, default=None,
                        help="Stop after this many frames.")
    parser.add_argument("--native_io", action="store_true",
                        help="Decode an MJPEG .avi with the native C++ "
                             "reader (threads, one call per chunk).")
    parser.add_argument("--draw_detections", action="store_true",
                        help="Also draw raw detections under the tracks.")
    parser.add_argument("--profile", action="store_true",
                        help="Print a per-stage timing breakdown at exit.")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Path for periodic tracker-state snapshots "
                             "(msgpack; written atomically).")
    parser.add_argument("--checkpoint_interval", type=int, default=500,
                        help="Frames between snapshots when --checkpoint "
                             "is set.")
    parser.add_argument("--resume", type=str, default=None,
                        help="Resume tracker state from a snapshot file "
                             "(track ids continue where they left off).")
    return parser.parse_args(argv)


def _refuse_unported(args) -> None:
    """Exit, naming the flag, on a run that asks for what is not ported."""
    refusals = [
        (not args.input, "--input",
         f"without --input the source is webcam {args.webcam_id}; the port "
         "has no camera capture (V4L2), pass an MJPEG .avi or a .npy file"),
        (args.show_display, "--show_display",
         "a display window needs a GUI toolkit, which the port does not "
         "use; the annotated video is saved unless --no_save"),
    ]
    for hit, flag, why in refusals:
        if hit:
            raise SystemExit(f"{flag}: {why} (see ROADMAP.md)")


def main(argv=None):
    args = parse_arguments(argv)

    # --- flag validation (before any video/pipeline work) ----------------------
    if args.gallery_strategy == "ema" and args.tracker != "deepsort":
        # fail loudly rather than silently running motion-only tracking
        # while the user believes the EMA appearance bank is active
        raise SystemExit(
            f"--gallery_strategy ema requires --tracker deepsort (the "
            f"motion-only '{args.tracker}' core has no appearance gallery)")
    if args.nsa and args.tracker != "deepsort":
        raise SystemExit(
            f"--nsa requires --tracker deepsort (the motion-only "
            f"'{args.tracker}' core takes fixed-noise KF updates)")
    _refuse_unported(args)

    from .runtime.checkpoint import load_state, save_state
    from .runtime.pipeline import TrackingPipeline
    from .runtime.profiler import CudaStageTimer, StageTimer
    from .utils import visualization
    from .utils.video_io import NativeVideoReader, VideoReader, VideoWriter

    # --- video input ----------------------------------------------------------
    try:
        reader = None
        if args.native_io:
            if Path(args.input).suffix.lower() == ".avi":
                reader = NativeVideoReader(args.input,
                                           max_frames=args.max_frames)
                print("Using native C++ video decoder")
            else:
                print(f"--native_io: the native decoder reads MJPEG .avi "
                      f"files; using the threaded reader for {args.input}")
        if reader is None:
            reader = VideoReader(args.input, max_frames=args.max_frames)
    except NotImplementedError as e:
        raise SystemExit(f"--input {args.input}: {e}") from e
    source_name = Path(args.input).stem
    print(f"Input: {source_name} ({reader.width}x{reader.height} @ "
          f"{reader.fps:.1f} fps, {reader.frame_count or '?'} frames)")
    chunk = args.chunk_size

    try:
        # --- pipeline ----------------------------------------------------------
        print(f"Initializing tracking pipeline on {args.device}...")
        extra = {}
        if args.input_shape:
            extra["input_shape"] = (args.input_shape, args.input_shape)
        if args.tracker == "deepsort" and args.gallery_strategy == "ema":
            from .core.state import TrackerParams
            extra["tracker_params"] = TrackerParams(
                max_cosine_distance=config.DEEPSORT_MAX_DIST,
                nn_budget=1,  # EMA bank occupies one gallery slot
                max_iou_distance=config.DEEPSORT_MAX_IOU_DISTANCE,
                max_age=config.DEEPSORT_MAX_AGE,
                n_init=config.DEEPSORT_N_INIT,
                max_tracks=config.MAX_TRACKS,
                max_detections=config.MAX_DETECTIONS,
                feature_dim=config.REID_FEATURE_DIM,
                ema_alpha=args.ema_alpha,
                nsa=args.nsa,
            )
        elif args.nsa:
            extra["nsa"] = True
        pipeline = TrackingPipeline(
            variant=args.variant,
            conf_threshold=args.conf_thresh,
            yolo_weights=args.yolo_weights,
            reid_weights=args.reid_weights,
            chunk_size=chunk,
            letterbox_auto=args.auto_input,
            tracker=args.tracker,
            gmc=args.gmc,
            detect_dtype=args.detect_dtype,
            reid_dtype=args.reid_dtype,
            reid_quant=(None if args.reid_quant in (None, "none")
                        else args.reid_quant),
            yolo_quant=(None if args.yolo_quant in (None, "none")
                        else args.yolo_quant),
            device=args.device.lower(),
            **extra,
        )
        if args.profile:
            # before the warm-up, which captures the stamped step
            pipeline.stage_timer = CudaStageTimer()
        print("Warming up the detect+track step (builds the CUDA kernel on "
              "first use)...")
        secs = pipeline.warm_up((reader.height, reader.width))
        print(f"  ready in {secs:.1f}s")

        # --- tracker-state checkpointing (streaming snapshots / resume) --------
        if args.resume:
            pipeline.state = load_state(args.resume, pipeline.core_params,
                                        device=pipeline.device)
            print(f"Resumed tracker state from {args.resume}")
        ckpt_path = Path(args.checkpoint) if args.checkpoint else None
        timer = StageTimer() if args.profile else None

        # --- video output ------------------------------------------------------
        writer = None
        if not args.no_save:
            name = args.output_filename or (
                f"{source_name}_tracked_{datetime.now():%Y%m%d_%H%M%S}.mp4")
            writer = VideoWriter(str(Path(args.output_dir) / name),
                                 reader.fps or config.DEFAULT_OUTPUT_FPS,
                                 (reader.height, reader.width))
            print(f"Saving to: {writer.path}")
    except BaseException:
        reader.release()
        raise

    # frames kept for drawing (results arrive one chunk behind); headless,
    # the chunks go straight to the pipeline
    frame_store: dict = {}

    def indexed_chunks():
        i = 0
        for c in reader.chunks(chunk):
            for f in c:
                frame_store[i] = f
                i += 1
            yield c

    use_chunked = writer is None
    n_frames = 0
    n_tracks_total = 0
    n_skipped = 0
    t_start = time.perf_counter()
    t_compute = 0.0
    try:
        t0 = time.perf_counter()
        for result in pipeline.process_chunks(
                reader.chunks(chunk) if use_chunked else indexed_chunks()):
            dt = time.perf_counter() - t0
            t_compute += dt
            if timer:
                timer.add("detect+track", dt)
            frame = frame_store.pop(result.frame_index, None)
            n_frames += 1
            n_tracks_total += len(result.tracks)

            # a per-frame presentation error skips the frame but keeps the
            # pipeline alive, as the JAX CLI does
            if writer is not None:
                try:
                    with (timer.stage("draw+write") if timer
                          else contextlib.nullcontext()):
                        vis = frame
                        if args.draw_detections:
                            vis = visualization.draw_detections(
                                vis, result.det_boxes, result.det_scores,
                                result.det_labels)
                        vis = visualization.draw_tracks(vis, result.tracks)
                        fps_now = n_frames / max(t_compute, 1e-9)
                        vis = visualization.draw_info_panel(vis, [
                            "AICamera",
                            f"Input: {source_name}",
                            f"FPS: {fps_now:.1f}",
                            f"Tracks: {len(result.tracks)}",
                        ])
                        writer.write(vis)
                except Exception as e:  # noqa: BLE001
                    n_skipped += 1
                    print(f"Warning: frame {result.frame_index} "
                          f"presentation error ({e}); continuing.")
            if n_frames % 100 == 0:
                print(f"  processed {n_frames} frames "
                      f"({n_frames / max(t_compute, 1e-9):.1f} FPS)")
            if ckpt_path and n_frames % max(args.checkpoint_interval, 1) == 0:
                with (timer.stage("checkpoint") if timer
                      else contextlib.nullcontext()):
                    save_state(ckpt_path, pipeline.state)
            t0 = time.perf_counter()
    except KeyboardInterrupt:
        print("\nInterrupted — shutting down cleanly.")
    finally:
        if ckpt_path and n_frames:
            save_state(ckpt_path, pipeline.state)
            print(f"Final tracker state saved to {ckpt_path}")
        reader.release()
        if writer is not None:
            writer.release()     # every queued frame, or it raises
            print(f"Saved {writer.frames_written} frames to {writer.path}")

    wall = time.perf_counter() - t_start
    print("-" * 60)
    print(f"Processed {n_frames} frames in {wall:.2f}s wall "
          f"({n_frames / max(wall, 1e-9):.1f} FPS incl. decode+draw; "
          f"{n_frames / max(t_compute, 1e-9):.1f} FPS detect+track)")
    print(f"Average tracks per frame: "
          f"{n_tracks_total / max(n_frames, 1):.1f}")
    if writer is not None:
        print(f"Presentation errors: {n_skipped} frames skipped")
    if timer:
        print(timer.report())
        pipeline.settle()
        print(pipeline.stage_timer.report())


if __name__ == "__main__":
    main()
