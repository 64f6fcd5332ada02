"""Model zoo of the port: the GQA decoders (yi-6b, minitron-8b, qwen3-32b,
gemma2-2b, and olmoe-1b-7b with its routed experts in ``moe.py``), their
full-sequence forward and loss, and the train step."""
