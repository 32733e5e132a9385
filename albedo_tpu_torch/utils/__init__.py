"""Device selection and the training watchdog."""
