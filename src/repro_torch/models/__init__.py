"""Model definitions: dense layers and the decoder transformer."""
