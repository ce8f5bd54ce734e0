"""Frame decoding, pair datasets and host-to-device prefetch."""
