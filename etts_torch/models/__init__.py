"""Inference models of the port: the AR TTS and the WaveRNN vocoder."""
