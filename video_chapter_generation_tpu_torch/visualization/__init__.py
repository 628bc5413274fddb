"""Interpretability tools (Grad-CAM, saliency, integrated gradients) and
the chapter frame strip."""
