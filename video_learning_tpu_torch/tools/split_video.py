"""Video -> frame folder extraction through ffmpeg.

The port's counterpart of ``video_learning_tpu/tools/split_video.py``:
extracts the frames of each input video into a folder of its own, ready
for the packer's video mode.  ``ffmpeg`` is found on PATH; without it the
tool raises with the JAX tool's message.

Usage:
  python -m video_learning_tpu_torch.tools.split_video <out_dir> <video>... \\
      [--fps N] [--format jpg]
"""


import argparse
import os
import shutil
import subprocess

from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def split_video(video_path, out_dir, fps=None, fmt="jpg"):
    if shutil.which("ffmpeg") is None:
        error("ffmpeg is not available on this system")
    name = os.path.splitext(os.path.basename(video_path))[0]
    target = os.path.join(out_dir, name)
    os.makedirs(target, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", video_path, "-loglevel", "error"]
    if fps:
        cmd += ["-vf", "fps=%s" % fps]
    cmd += [os.path.join(target, "f_%04d." + fmt)]
    info("Running: %s" % " ".join(cmd))
    ret = subprocess.run(cmd)
    if ret.returncode != 0:
        error("ffmpeg failed for %s" % video_path)
    nframes = len(os.listdir(target))
    info("Extracted %d frames to %s" % (nframes, target))
    return target


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir")
    parser.add_argument("videos", nargs="+")
    parser.add_argument("--fps", type=float)
    parser.add_argument("--format", default="jpg")
    args = parser.parse_args(argv)
    return [split_video(v, args.out_dir, args.fps, args.format)
            for v in args.videos]


if __name__ == "__main__":
    main()
