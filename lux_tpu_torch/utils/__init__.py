"""Configuration, device selection and timing."""
