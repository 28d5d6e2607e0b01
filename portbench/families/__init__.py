"""Detector families, found by name.

``config["model"]["family"]`` names a module ``portbench/families/<family>.py``
under the run's root, which ``harness.family_module`` loads by its path, so
that a later change adds a family by adding one file. A family module
exports:

- ``program_kwargs(config) -> dict``: the detector's arguments to the
  program's pipelines (the tracker's are ``drivers/common.py``'s);
- ``make_weights(spec, config, seed, device) -> tree``: the Flax tree of the
  detector's weights for a dict ``weights`` spec, made from the seed (a
  string spec is a file path and needs no family);
- ``Reference(config, frame_hw, tree, device, precision)``: called on a
  ``(B, H, W, 3)`` uint8 tensor of frames on ``device``, it returns per
  frame the kept ``(boxes (n, 4) in frame pixels, scores (n,), classes
  (n,) int32)`` in score order, after the family's own pre- and
  post-processing: plain PyTorch in f32 (TF32 off), nothing of the program;
  ``precision`` ``"fp8"`` is the control (``reference/nets.py``);
- ``flops(config) -> int``: the detector's FLOPs for one frame at
  ``config["pipeline"]["input_hw"]``.
"""
