"""Host-side image loading for detect."""
