"""Model families, one module each, found by a configuration's `family`
(manifest.family). Each module exposes:

  spec(cfg)            weights.Spec: the seeded initial state, in the
                       program's module names
  forward(w, x, cfg, *, cast, train=False, masks=None)
                       (B, 1, H, W) float32 pixels -> (B, Sy, Sx, 5+C)
                       head: the plain float32 reference, which imports
                       nothing of yogo_tpu_torch; a family with no
                       training path raises on train=True
  grid(cfg)            (Sx, Sy) of the head
  macs_per_image(cfg)  multiply-accumulates of one image's forward pass

A configuration of a new family adds families/<family>.py, and no file
that is here changes.
"""
