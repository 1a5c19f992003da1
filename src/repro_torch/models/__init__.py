"""The dense-LM serving path: embeddings, GQA attention (naive and through
the flash kernel), feed-forward blocks and the transformer around them."""
