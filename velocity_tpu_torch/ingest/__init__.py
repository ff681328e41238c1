"""Host-side video decode (cv2, imported lazily)."""
