"""File formats the runtime reads and writes: YAML, the CLIP tokenizer, video."""
