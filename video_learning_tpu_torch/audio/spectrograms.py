"""Audio -> spectrogram frame folders for the audionet branch.

The port's counterpart of ``video_learning_tpu/audio/spectrograms.py``:
a short-time magnitude spectrogram of each fixed time window of an audio
file (a numpy STFT with a Hann window), mapped through a jet colormap to
uint8 RGB PNGs, one folder per clip, which the packer reads as video
frames.  The arrays equal the JAX module's.

Input formats: wav natively (the standard library's ``wave``); mp3 and
the other compressed formats decode through an ``ffmpeg`` / ``avconv``
subprocess found on PATH, and without one the call raises naming the
missing decoder.  Writing the PNGs imports PIL there and only there.

Usage:
  python -m video_learning_tpu_torch.audio.spectrograms <out_dir> <audio>... \\
      [--window-sec 1.0] [--stft-win 0.040] [--stft-step 0.020]
"""


import argparse
import os
import shutil
import subprocess
import tempfile
import wave

import numpy as np

from video_learning_tpu_torch.utils import ensure_console_logging, error, info

AUDIO_EXTENSIONS = (".wav", ".mp3", ".aif", ".aiff", ".ogg", ".flac",
                    ".m4a", ".aac", ".au")


def read_wav(path):
    """Read a PCM wav into a mono float array + sample rate."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 1:
        # 8-bit PCM WAV stores UNSIGNED samples centered at 128
        data = np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0
        scale = 127.0
    elif width in (2, 4):
        dtype = {2: np.int16, 4: np.int32}[width]
        data = np.frombuffer(raw, dtype).astype(np.float64)
        scale = float(np.iinfo(dtype).max)
    else:
        error("Unsupported wav sample width: %d" % width)
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data / scale, rate


def _decoder_binary():
    for name in ("ffmpeg", "avconv"):
        path = shutil.which(name)
        if path:
            return path
    return None


def read_audio(path):
    """Read any supported audio file into mono float samples + rate.

    wav decodes natively; everything else (mp3 first among them) shells
    out to ffmpeg/avconv to transcode to a temporary 16-bit PCM wav and
    reads that."""
    if path.lower().endswith(".wav"):
        return read_wav(path)
    decoder = _decoder_binary()
    if decoder is None:
        error("Decoding [%s] requires ffmpeg or avconv on PATH "
              "(only .wav decodes natively)" % path)
    tmp = tempfile.NamedTemporaryFile(suffix=".wav", delete=False)
    tmp.close()
    try:
        proc = subprocess.run(
            [decoder, "-y", "-v", "error", "-i", path,
             "-acodec", "pcm_s16le", tmp.name],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        if proc.returncode != 0:
            error("%s failed on [%s]: %s"
                  % (os.path.basename(decoder), path,
                     proc.stderr.decode("utf-8", "replace").strip()[:500]))
        return read_wav(tmp.name)
    finally:
        os.unlink(tmp.name)


def stft_magnitude(signal, rate, win_sec, step_sec):
    win = max(8, int(win_sec * rate))
    step = max(1, int(step_sec * rate))
    if len(signal) < win:
        return np.zeros((1, win // 2))
    frames = []
    hann = np.hanning(win)
    for start in range(0, len(signal) - win + 1, step):
        seg = signal[start:start + win] * hann
        mag = np.abs(np.fft.rfft(seg))[: win // 2]
        frames.append(mag)
    return np.stack(frames)


def jet_colormap(norm):
    """Map [0,1] -> uint8 RGB with the classic jet colormap (piecewise
    linear, close to matplotlib's jet)."""
    x = np.clip(norm, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def generate_spectrogram_frames(wav_path, out_dir, window_sec=1.0,
                                stft_win=0.040, stft_step=0.020):
    """One folder of per-window spectrogram PNGs per audio file."""
    from PIL import Image
    signal, rate = read_audio(wav_path)
    name = os.path.splitext(os.path.basename(wav_path))[0]
    target = os.path.join(out_dir, name)
    os.makedirs(target, exist_ok=True)
    samples_per_window = int(window_sec * rate)
    count = 0
    for wstart in range(0, max(1, len(signal) - samples_per_window + 1),
                        samples_per_window):
        chunk = signal[wstart:wstart + samples_per_window]
        spec = stft_magnitude(chunk, rate, stft_win, stft_step)
        if spec.size == 0:
            continue
        spec = np.log1p(spec).T  # freq x time
        denom = spec.max() or 1.0
        img = jet_colormap(spec / denom)[::-1]  # low freq at the bottom
        Image.fromarray(img).save(
            os.path.join(target, "spec_%04d.png" % count))
        count += 1
    info("Wrote %d spectrogram frames for %s" % (count, wav_path))
    return target, count


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir")
    parser.add_argument("wavs", nargs="+")
    parser.add_argument("--window-sec", type=float, default=1.0)
    parser.add_argument("--stft-win", type=float, default=0.040)
    parser.add_argument("--stft-step", type=float, default=0.020)
    args = parser.parse_args(argv)
    audio = [w for w in args.wavs
             if w.lower().endswith(AUDIO_EXTENSIONS)]
    for skipped in set(args.wavs) - set(audio):
        info("Skipping non-audio input [%s] (recognized: %s)"
             % (skipped, " ".join(AUDIO_EXTENSIONS)))
    return [generate_spectrogram_frames(w, args.out_dir, args.window_sec,
                                        args.stft_win, args.stft_step)
            for w in audio]


if __name__ == "__main__":
    main()
