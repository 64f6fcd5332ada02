"""Model zoo of the port: the dense GQA decoder (yi-6b, qwen3-32b)."""
