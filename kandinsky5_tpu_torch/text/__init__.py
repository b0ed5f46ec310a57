"""Text towers of the port: Qwen2.5-VL (``qwen``), CLIP (``clip``) and the
conditioning embedder (``embedder``)."""
