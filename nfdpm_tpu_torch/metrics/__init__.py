"""Sample-quality metrics: FID/KID (Inception-v3, CLIP ViT-B/32), SSIM/PSNR, stats."""

from . import compute, fid, image_quality  # noqa: F401
