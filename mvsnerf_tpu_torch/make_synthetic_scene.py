"""Write a synthetic DTU-format scene tree (cameras, images, GT depths), so
that the CLIs run without the real dataset (counterpart of the JAX
package's scripts/make_synthetic_scene.py, with the same arguments):

    python -m mvsnerf_tpu_torch.make_synthetic_scene /tmp/dtu_synth
    python -m mvsnerf_tpu_torch.train_finetune --dataset_name dtu_ft \\
        --datadir /tmp/dtu_synth/scan1 --expname smoke --max_steps 50 \\
        --with_rgb_loss --imgScale_train 0.1 --imgScale_test 0.1 --pad 4
    python -m mvsnerf_tpu_torch.make_synthetic_scene /tmp/dtu_ms scan3,scan4

The first form writes `scan1` under the root given; the second writes
the scans named (take them from the packaged train list) and
`<root>/scans.txt` for `--scan_list`. The root has no default (JAX's
script writes to /tmp/dtu_synth without one). Each scan is 49 views of
240x192 PNGs under 7 lights and 49 depth maps of 1200x1600 (~376 MB);
for a generalizable run at `--imgScale_train 1.0`, call
`data.synthetic.write_dtu_scene` with `img_hw=(512, 640)`."""

from __future__ import annotations

import sys

from .data.synthetic import write_dtu_multiscan, write_dtu_scene


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not 1 <= len(argv) <= 2:
        raise SystemExit("usage: python -m mvsnerf_tpu_torch."
                         "make_synthetic_scene <root> [scan3,scan4,...]")
    if len(argv) == 2:
        write_dtu_multiscan(argv[0], argv[1].split(","))
    else:
        write_dtu_scene(argv[0])


if __name__ == "__main__":
    main()
