"""Model zoo of the port: the dense GQA decoders (yi-6b, qwen3-32b,
gemma2-2b), their full-sequence forward and loss, and the train step."""
