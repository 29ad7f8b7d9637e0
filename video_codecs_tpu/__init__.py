"""video_codecs_tpu — HEVC/H.264 codec framework on JAX devices."""
