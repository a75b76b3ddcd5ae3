from .log_file import LogFileConfig, LogFileReader

__all__ = ["LogFileReader", "LogFileConfig"]
