"""Host utilities: image IO and the resumable corpus runner (utils.io)."""
