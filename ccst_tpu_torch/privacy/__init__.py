"""The privacy analysis: the style inverter, its training and evaluation
(PSNR, perceptual distance, LPIPS), and the lightweight GAN."""
