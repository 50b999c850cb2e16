"""The AI-platform runtime's accounting: DCIM energy telemetry (``telemetry``)."""
