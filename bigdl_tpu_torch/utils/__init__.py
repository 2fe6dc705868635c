"""Host-side helpers of the port (device resolution, kernel builds)."""
