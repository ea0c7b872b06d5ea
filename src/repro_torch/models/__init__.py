"""The LM substrate's models in PyTorch: layers, GQA attention, decoder
blocks and the top-level transformer (``dense`` and ``vlm`` families)."""
