"""The UNet3D, its blocks and layers, the CLIP text encoder and the VAE."""
