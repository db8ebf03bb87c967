"""Live audio source block over the PortAudio binding (counterpart of
bifrost_tpu/blocks/audio.py; reference python/bifrost/blocks/audio.py).
Building the block opens the capture stream, so without a PortAudio
library it raises PortAudioError at once (files: blocks.read_wav).
"""

from __future__ import annotations

from ..pipeline import SourceBlock
from .. import portaudio as audio


class AudioSourceBlock(SourceBlock):
    """Stream interleaved PCM frames from an audio input device.

    `audio_kwargs` go to portaudio.Stream (rate, channels, nbits,
    input_device, ...); each pipeline sequence is one open stream.
    """

    def __init__(self, audio_kwargs, gulp_nframe, *args, **kwargs):
        self.audio_kwargs = dict(audio_kwargs)
        self.reader = None
        self.noverflow = 0   # device-dropped-frame events (observability)
        super().__init__([self.audio_kwargs], gulp_nframe, *args, **kwargs)

    def create_reader(self, kwargs):
        kwargs = dict(kwargs)
        kwargs.setdefault("frames_per_buffer", self.gulp_nframe)
        kwargs["mode"] = "r"
        self.reader = audio.open(**kwargs)
        return self.reader

    def on_sequence(self, reader, kwargs):
        ohdr = {
            "_tensor": {
                "dtype": f"i{reader.nbits}",
                "shape": [-1, reader.channels],
                "labels": ["time", "pol"],
                "scales": [[0, 1.0 / reader.rate], None],
                "units": ["s", None],
            },
            "frame_rate": reader.rate,
            "input_device": reader.input_device,
            "name": f"audio_{reader.input_device}",
        }
        return [ohdr]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        try:
            reader.readinto(ospan.data.numpy())
        except audio.PortAudioOverflow:
            # Recoverable: the device dropped frames while we stalled but
            # THIS buffer is filled — count the drop and keep streaming
            # (ending a live observation on a scheduler hiccup would be
            # data loss, not safety).
            self.noverflow += 1
            return [ospan.nframe]
        except audio.PortAudioError as e:
            # Device gone / stream stopped: end the sequence, loudly
            # enough to diagnose.
            import sys
            print(f"bifrost_tpu_torch.audio: capture ended: {e}",
                  file=sys.stderr)
            return [0]
        return [ospan.nframe]

    def stop(self):
        if self.reader is not None:
            self.reader.stop()

    def on_shutdown(self):
        # Pipeline.shutdown's unblock hook, called
        # from another thread while on_data may be blocked inside
        # Pa_ReadStream: abort() forces that read to return (and skips
        # the stream lock the blocked reader holds) so run() can join —
        # same pattern as ShmReceiveBlock.on_shutdown.
        r = self.reader
        if r is not None:
            r.abort()

    def shutdown(self):
        if self.reader is not None:
            self.reader.close()
            self.reader = None

    def main(self):
        try:
            super().main()
        finally:
            self.shutdown()


def read_audio(audio_kwargs, gulp_nframe, *args, **kwargs):
    """Capture from an audio input device
    read_audio({'rate': 44100,
    'channels': 2, 'nbits': 16}, gulp_nframe=1024)."""
    return AudioSourceBlock(audio_kwargs, gulp_nframe, *args, **kwargs)
